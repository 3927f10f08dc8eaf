"""Online HTTP serving front end over the continuous-batching engine
(counterpart of llark_tpu/inference/http_server.py), on the standard
library's HTTP server:

  python -m llark_tpu_torch.inference.http_server \\
      --checkpoint-dir run [--port 8000] [--continuous-batching 4] \\
      [--kv-cache-int8] [--kv-block-size 128 --prefill-chunk 256] \\
      [--speculative ngram --allow-divergent-spec] [--device cpu]

  POST /generate   {"prompt": "...", "audio_encoding": [[...]] | "<base64
                    .npy>" | null, "max_new_tokens": 64?}
                   -> {"completion": "...", "tokens": [...], "ttft_s": ...,
                       "latency_s": ...}
  GET  /health     -> {"status": "ok", "slots_free": N, "queued": M}

Handler threads only build `Request`s and hand them over under a lock; one
engine thread owns the server and issues ALL of its device work (admit,
then decode), so no two threads launch onto the card. Handlers wait on a
per-request Event the engine sets once the request is done. The server
binds the loopback interface unless told otherwise.

With --mesh-shape (under torchrun, one process a rank) every rank loads the
model and keeps its shards (`inference/server.py` mesh serving); rank 0
runs the HTTP front end and its engine thread broadcasts each round's
admitted requests to the other ranks, which run the same rounds
(`follow`).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.parallel import comm

log = logging.getLogger(__name__)


def engine_round(srv: BatchedServer, new_requests) -> bool:
    """Queue the round's new requests, then admit and decode once; False
    when there was nothing to do. Every rank of a mesh server runs the same
    rounds on the same requests."""
    srv._queue.extend(new_requests)
    if not srv._queue and not srv._active():
        return False
    srv._admit()
    srv._decode_round()
    return True


def _abort_all(srv: BatchedServer) -> None:
    """Drop every queued and in-flight request of a failed round."""
    srv._queue.clear()
    for slot, r in enumerate(srv._slot_req):
        if r is not None:
            srv._slot_req[slot] = None
            # paged: return the aborted row's pool blocks, which clearing
            # the slot alone would leak
            srv._release_blocks(slot)


def follow(server: BatchedServer) -> None:
    """A mesh server's rank other than 0: run the rounds rank 0's engine
    broadcasts, on the same requests, until it stops."""
    with torch.inference_mode():
        while True:
            stop, new_requests = comm.broadcast_object(None, 0, comm.world())
            if stop:
                return
            try:
                engine_round(server, new_requests)
            except Exception:  # noqa: BLE001 -- rank 0 fails the same round
                log.exception("engine step failed; dropping in-flight requests")
                _abort_all(server)


class OnlineEngine:
    """Drives a BatchedServer continuously: submissions from any thread,
    admission and decode on the engine thread alone."""

    def __init__(self, server: BatchedServer, idle_sleep_s: float = 0.002):
        self.server = server
        self.idle_sleep_s = idle_sleep_s
        self._lock = threading.Lock()
        self._pending = []  # (Request, Event), handed to the engine thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- client side -------------------------------------------------------
    def submit(self, req: Request) -> threading.Event:
        ev = threading.Event()
        req.submitted_at = time.time()
        with self._lock:
            self._pending.append((req, ev))
        return ev

    def generate(self, req: Request, timeout: Optional[float] = None) -> Request:
        ev = self.submit(req)
        if not ev.wait(timeout):
            raise TimeoutError("generation timed out")
        return req

    # -- engine side -------------------------------------------------------
    def _run(self) -> None:
        dev = self.server.device
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        srv = self.server
        tracked = {}  # id -> (Request, Event)
        while True:
            stop = self._stop.is_set()
            with self._lock:
                newly, self._pending = ([], self._pending) if stop else (self._pending, [])
            if srv.mesh is not None:
                # the round's admissions (or the stop) go to every rank
                comm.broadcast_object((stop, [req for req, _ in newly]), 0, comm.world())
            if stop:
                break
            for req, ev in newly:
                tracked[id(req)] = (req, ev)
            try:
                if not engine_round(srv, [req for req, _ in newly]):
                    time.sleep(self.idle_sleep_s)
            except Exception as e:  # noqa: BLE001 -- one bad request must not
                # end the serving loop: fail every queued and in-flight
                # request with the error (each reply carries it) and go on
                # taking new work
                log.exception("engine step failed; failing in-flight requests")
                _abort_all(srv)
                for req, ev in tracked.values():
                    req.error = f"{type(e).__name__}: {e}"
                    ev.set()
                tracked.clear()
                continue
            for rid in [r for r, (req, _) in tracked.items() if req.done]:
                tracked.pop(rid)[1].set()
        # on shutdown: fail fast for anything still in flight
        for req, ev in tracked.values():
            req.error = "server shutting down"
            ev.set()

    def start(self) -> "OnlineEngine":
        if self.server.driver is not None:
            raise RuntimeError("server already has a driver")
        self.server.driver = self  # blocks direct serve() calls (cache race)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.server.driver is self:
            self.server.driver = None

    def stats(self) -> dict:
        srv = self.server
        return {
            "status": "ok",
            "slots_free": len(srv._free_slots()),
            "queued": len(srv._queue),
        }


def make_handler(engine: OnlineEngine, bundle, prompt_cap: int):
    from llark_tpu_torch.infer import _normalize_encoding, build_prompt_ids

    # refuse oversized bodies BEFORE reading them: the largest legitimate
    # payload is a base64 .npy of [max_audio_frames, mm_hidden] f32 (clients
    # may send a few times more frames, which the engine cuts) plus JSON
    srv = engine.server
    body_cap = 4 * srv.max_audio_frames * srv.cfg.mm_hidden_size * 4 * 4 // 3 + 65536

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # through logging, not stderr
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, engine.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > body_cap:
                    self._reply(413, {"error": f"request body {n} bytes exceeds cap {body_cap}"})
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = payload.get("prompt") or "Describe the audio."
                enc = payload.get("audio_encoding")
                if isinstance(enc, str):  # base64-encoded .npy bytes
                    enc = np.load(io.BytesIO(base64.b64decode(enc)))
                audio = None
                t = 0
                if enc is not None:
                    # frame-cap BEFORE building the prompt ids: the engine
                    # clamps to max_audio_frames, so an uncapped count would
                    # insert more patch tokens than frames get spliced in
                    audio = _normalize_encoding(enc, srv.max_audio_frames)
                    if audio.ndim != 2 or audio.shape[1] != srv.cfg.mm_hidden_size:
                        self._reply(400, {
                            "error": f"audio_encoding must be [T, {srv.cfg.mm_hidden_size}], "
                                     f"got {list(audio.shape)}"})
                        return
                    t = audio.shape[0]
                ids = np.asarray(build_prompt_ids(prompt, t, bundle), np.int32)
                if len(ids) > prompt_cap:
                    self._reply(413, {"error": f"prompt too long ({len(ids)} > {prompt_cap} "
                                               "tokens)"})
                    return
                mnt = payload.get("max_new_tokens")
                req = engine.generate(
                    Request(ids, audio, max_new_tokens=int(mnt) if mnt is not None else None),
                    timeout=float(payload.get("timeout", 300.0)),
                )
                if not req.done or req.error:
                    self._reply(503, {"error": req.error or "generation aborted"})
                    return
                self._reply(200, {
                    "completion": bundle.tokenizer.decode(req.tokens),
                    "tokens": req.tokens,
                    "ttft_s": (req.first_token_at or 0) - req.submitted_at,
                    "latency_s": (req.finished_at or 0) - req.submitted_at,
                })
            except Exception as e:  # noqa: BLE001 -- reported as HTTP 500
                log.exception("generate failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_http(server: BatchedServer, bundle, host: str = "127.0.0.1", port: int = 8000):
    """Start the engine and the HTTP listener; returns (httpd, engine) for
    the caller to run (httpd.serve_forever()) and to shut down."""
    engine = OnlineEngine(server).start()
    cap = min(
        server.max_cache_len - server.gen_cfg.max_new_tokens - server._headroom(),
        server._prefix_len + server.prompt_buckets[-1],
    )
    httpd = ThreadingHTTPServer((host, port), make_handler(engine, bundle, cap))
    return httpd, engine


def main(argv=None):
    from llark_tpu_torch.inference.common import add_generation_args, check_serving_args

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--ckpt-num", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--continuous-batching", type=int, default=4, metavar="SLOTS")
    p.add_argument("--max-audio-frames", type=int, default=256)
    p.add_argument("--prompt-buckets", default="128,512")
    p.add_argument("--mesh-shape", default=None,
                   help="serve over a (data, fsdp, tensor) mesh of the launched ranks, "
                        "e.g. 1,1,2 under torchrun --nproc-per-node 2: rank 0 runs the "
                        "HTTP front end, every rank the engine")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default: the GPU; 'cpu' runs the plain "
                        "PyTorch path)")
    add_generation_args(p)
    args = p.parse_args(argv)
    # the daemon IS the continuous-batching engine: beam flags are refused,
    # not ignored; --speculative draft runs the fused draft-verify rounds in
    # the slot engine, --speculative ngram the host-proposal rounds
    check_serving_args(args)
    with contextlib.ExitStack() as stack:
        mesh = None
        if args.mesh_shape:
            from llark_tpu_torch.parallel.mesh import mesh_session

            shape = tuple(int(x) for x in args.mesh_shape.replace(",", " ").split())
            mesh = stack.enter_context(mesh_session(shape, device=args.device))
        _serve_main(args, mesh)


def _serve_main(args, mesh) -> None:
    from llark_tpu_torch.infer import _common_prompt_prefix, build_prompt_ids
    from llark_tpu_torch.inference.common import (
        apply_serving_overrides,
        load_draft,
        make_gen_cfg,
    )
    from llark_tpu_torch.models.utils import load_pretrained_model

    cfg, params, bundle = load_pretrained_model(args.checkpoint_dir, args.ckpt_num, args.device)
    cfg = apply_serving_overrides(args, cfg)
    draft_cfg, draft_params = load_draft(args, args.device)
    shared_prefix = None
    if args.prefix_cache:
        # the daemon cannot see future prompts, but every prompt it builds
        # opens with the same conversation header: the shareable prefix of
        # two maximally different probe prompts
        probes = [
            np.asarray(build_prompt_ids("probe one", 4, bundle), np.int32),
            np.asarray(build_prompt_ids("entirely different probe text", 0, bundle), np.int32),
        ]
        shared_prefix = _common_prompt_prefix(
            probes, bundle.audio_patch_id, min_len=max(8, args.kv_block_size or 0)
        )
        if shared_prefix is None:
            log.warning("--prefix-cache: conversation header too short to share; "
                        "serving without it")
        else:
            log.info("--prefix-cache: caching the %d-token conversation header",
                     len(shared_prefix))
    server = BatchedServer(
        cfg, params, bundle.audio_patch_id, make_gen_cfg(args),
        max_batch=args.continuous_batching,
        max_cache_len=args.max_cache_len,
        prompt_buckets=tuple(int(x) for x in args.prompt_buckets.split(",")),
        max_audio_frames=args.max_audio_frames,
        prefill_chunk=args.prefill_chunk,
        tokenizer=bundle.tokenizer,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
        gamma=args.gamma,
        spec_rounds=args.spec_rounds,
        spec_mode="ngram" if args.speculative == "ngram" else None,
        kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks,
        admit_batch=args.admit_batch,
        admit_min_fill=args.admit_min_fill,
        admit_max_wait_s=args.admit_max_wait_ms / 1000.0,
        admit_reorder=args.admit_reorder,
        admit_reorder_age_s=args.admit_reorder_age_ms / 1000.0,
        decode_chunk=args.decode_chunk,
        decode_chunk_drain=args.decode_chunk_drain,
        drain_max_active=args.drain_max_active,
        allow_divergent_spec=args.allow_divergent_spec,
        shared_prefix_ids=shared_prefix,
        mesh=mesh,
        device=args.device,
    )
    if mesh is not None and torch.distributed.get_rank() != 0:
        follow(server)
        return
    httpd, engine = serve_http(server, bundle, args.host, args.port)
    log.info("serving on %s:%d (%d slots)", args.host, args.port, args.continuous_batching)
    try:
        httpd.serve_forever()
    finally:
        engine.stop()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
