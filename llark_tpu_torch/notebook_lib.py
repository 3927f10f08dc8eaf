"""Notebook helper: inline base64 HTML5 audio player (counterpart of
llark_tpu/notebook_lib.py).

Parity: m2t/notebook_lib.py:22-48 — embeds a WAV as a data-URI <audio>
element so evaluation notebooks can play clips without file serving.
"""

from __future__ import annotations

import base64
import io

import numpy as np


def audio_player_html(audio: np.ndarray, sample_rate: int = 44100) -> str:
    """Return an HTML string with an inline <audio> element for the clip."""
    import wave

    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    ints = (pcm * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1 if ints.ndim == 1 else ints.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(ints.tobytes())
    b64 = base64.b64encode(buf.getvalue()).decode("ascii")
    return (
        '<audio controls="controls">'
        f'<source src="data:audio/wav;base64,{b64}" type="audio/wav" />'
        "Your browser does not support the audio element."
        "</audio>"
    )


def display_audio(audio: np.ndarray, sample_rate: int = 44100):
    """Render the player in an IPython notebook (no-op string elsewhere)."""
    html = audio_player_html(audio, sample_rate)
    try:
        from IPython.display import HTML, display

        display(HTML(html))
    except ImportError:
        return html
    return html
