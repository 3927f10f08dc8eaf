// Native WebDataset tar shard loader.
//
// The training input pipeline's hot host path (reference: webdataset's
// Python tar iteration inside DataLoader workers, m2t/data_modules.py:466-520)
// rebuilt as a C++ loader: a pool of reader threads parses whole ustar
// shards ahead of the consumer (bounded readahead), grouping consecutive
// members that share a key into samples. Ordering is identical to a
// sequential read: shards are consumed in submission order, samples in
// shard order — only the parsing/IO runs ahead on background threads.
//
// C API (ctypes): opaque loader + sample handles; field payloads are
// returned as (pointer, size) pairs valid until ljt_sample_free.
//
// Build: llark_tpu_torch/native/build.py at first use
// (g++ -O3 -march=native -shared -fPIC -pthread), into llark_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// One arena per shard: the whole .tar lives in a single shared buffer and
// fields point into it. This avoids thousands of multi-MB malloc/munmap
// cycles per second from the reader threads (mmap-threshold allocations
// trigger TLB-shootdown IPIs that stall every thread in the process).
using Arena = std::shared_ptr<std::vector<uint8_t>>;

struct Field {
  std::string name;  // field name after the key prefix, e.g. "json"
  const uint8_t* ptr = nullptr;  // into the shard arena
  long size = 0;
  Arena arena;  // keeps the shard buffer alive
};

struct Sample {
  std::string key;
  std::vector<Field> fields;
};

// ---- ustar parsing --------------------------------------------------------

long parse_octal(const char* p, int n) {
  long v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    char c = p[i];
    if (c == ' ') continue;
    if (c < '0' || c > '7') break;
    v = (v << 3) | (c - '0');
  }
  return v;
}

// split "dir/key.field.ext" -> key="dir/key", field="field.ext"
void split_key_field(const std::string& name, std::string* key, std::string* field) {
  size_t slash = name.find_last_of('/');
  std::string dir = (slash == std::string::npos) ? "" : name.substr(0, slash);
  std::string fname = (slash == std::string::npos) ? name : name.substr(slash + 1);
  size_t dot = fname.find('.');
  std::string base = (dot == std::string::npos) ? fname : fname.substr(0, dot);
  *field = (dot == std::string::npos) ? "" : fname.substr(dot + 1);
  *key = dir.empty() ? base : dir + "/" + base;
}

// Parse one whole .tar file into grouped samples. Returns false on IO error.
bool parse_shard(const std::string& path, std::deque<Sample>* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return false; }
  long fsize = std::ftell(f);
  std::rewind(f);
  Arena arena = std::make_shared<std::vector<uint8_t>>();
  arena->resize(fsize > 0 ? fsize : 0);
  if (fsize > 0 &&
      std::fread(arena->data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  const uint8_t* base = arena->data();
  long pos = 0;
  const uint8_t* header;
  Sample current;
  bool have_current = false;
  std::string longname;  // GNU 'L' long-name payload for the next entry
  while (pos + 512 <= fsize && (header = base + pos, pos += 512, true)) {
    // two zero blocks = end of archive; a single zero header also stops us
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (header[i]) { all_zero = false; break; }
    if (all_zero) break;

    // validate the header checksum (offset 148, 8 bytes, octal of the sum
    // with the checksum field itself counted as spaces) — rejects
    // non-tar/corrupt input instead of yielding garbage samples
    long stored = parse_octal(reinterpret_cast<const char*>(header) + 148, 8);
    long computed = 0;
    for (int i = 0; i < 512; ++i)
      computed += (i >= 148 && i < 156) ? ' ' : header[i];
    if (stored != computed) {
      if (have_current) out->push_back(std::move(current));
      return false;
    }

    char namebuf[257] = {0};
    // ustar prefix field (offset 345, len 155) + name (offset 0, len 100)
    if (std::memcmp(header + 257, "ustar", 5) == 0 && header[345]) {
      size_t p = 0;
      for (; p < 155 && header[345 + p]; ++p) namebuf[p] = header[345 + p];
      namebuf[p] = '/';
      std::memcpy(namebuf + p + 1, header, 100);
    } else {
      std::memcpy(namebuf, header, 100);
    }
    std::string name(namebuf);
    if (!longname.empty()) {
      name = longname;
      longname.clear();
    }
    long size = parse_octal(reinterpret_cast<const char*>(header) + 124, 12);
    char typeflag = header[156];
    long padded = (size + 511) & ~511L;
    if (pos + size > fsize) break;  // truncated archive

    if (typeflag == 'L') {  // GNU long name: payload is the real name
      longname.assign(reinterpret_cast<const char*>(base + pos),
                      strnlen(reinterpret_cast<const char*>(base + pos), size));
      pos += padded;
      continue;
    }
    if (typeflag != '0' && typeflag != '\0') {  // skip non-regular files
      pos += padded;
      continue;
    }

    const uint8_t* payload = base + pos;
    pos += padded;

    std::string key, field;
    split_key_field(name, &key, &field);
    if (have_current && key != current.key) {
      out->push_back(std::move(current));
      current = Sample();
    }
    have_current = true;
    current.key = key;
    current.fields.push_back(Field{std::move(field), payload, size, arena});
  }
  if (have_current) out->push_back(std::move(current));
  return true;
}

// ---- threaded shard-readahead loader --------------------------------------

struct ShardSlot {
  std::deque<Sample> samples;
  bool done = false;   // parse finished
  bool failed = false; // IO error (skip-and-warn semantics)
};

struct Loader {
  std::vector<std::string> paths;
  std::deque<ShardSlot> slots;  // deque: no relocation, works move-only
  std::atomic<size_t> next_to_parse{0};
  size_t readahead;
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv;
  size_t consume_idx = 0;   // shard currently being consumed
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      size_t idx = next_to_parse.fetch_add(1);
      if (idx >= paths.size()) return;
      // bound readahead: wait until the consumer is close enough
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || idx < consume_idx + readahead;
        });
        if (stop.load()) return;
      }
      std::deque<Sample> parsed;
      bool ok = parse_shard(paths[idx], &parsed);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx].samples = std::move(parsed);
        slots[idx].done = true;
        slots[idx].failed = !ok;
      }
      cv.notify_all();
    }
  }

  Sample* next() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (consume_idx >= paths.size()) return nullptr;
      ShardSlot& slot = slots[consume_idx];
      if (!slot.done) {
        cv.wait(lk, [&] { return slots[consume_idx].done || stop.load(); });
        if (stop.load()) return nullptr;
        continue;
      }
      if (!slot.samples.empty()) {
        Sample* s = new Sample(std::move(slot.samples.front()));
        slot.samples.pop_front();
        return s;
      }
      // shard drained (or failed -> empty): advance and let workers refill
      ++consume_idx;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ljt_loader_open(const char** paths, long n_paths, int n_threads,
                      long readahead) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  for (size_t i = 0; i < L->paths.size(); ++i) L->slots.emplace_back();
  L->readahead = readahead > 0 ? static_cast<size_t>(readahead) : 2;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->threads.emplace_back(&Loader::worker, L);
  return L;
}

void* ljt_loader_next(void* h) {
  return static_cast<Loader*>(h)->next();
}

int ljt_loader_shard_failed(void* h, long idx) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || static_cast<size_t>(idx) >= L->slots.size()) return 0;
  std::lock_guard<std::mutex> lk(L->mu);
  return L->slots[idx].done && L->slots[idx].failed ? 1 : 0;
}

void ljt_loader_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->threads) t.join();
  delete L;
}

const char* ljt_sample_key(void* s) {
  return static_cast<Sample*>(s)->key.c_str();
}

long ljt_sample_nfields(void* s) {
  return static_cast<long>(static_cast<Sample*>(s)->fields.size());
}

const char* ljt_sample_field_name(void* s, long i) {
  return static_cast<Sample*>(s)->fields[i].name.c_str();
}

long ljt_sample_field_size(void* s, long i) {
  return static_cast<Sample*>(s)->fields[i].size;
}

const uint8_t* ljt_sample_field_data(void* s, long i) {
  return static_cast<Sample*>(s)->fields[i].ptr;
}

void ljt_sample_free(void* s) {
  delete static_cast<Sample*>(s);
}

}  // extern "C"
