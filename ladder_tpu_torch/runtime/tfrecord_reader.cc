// Native TFRecord image reader: mmap + O(1) record index + multithreaded
// batch assembly (a copy of ladder_tpu/runtime/tfrecord_reader.cc, so that
// ladder_tpu_torch stands alone).
//
// The reference's data path is tf.data's C++ runtime (TFRecordDataset,
// the reference's codes/models.py:373-386). This is a small C library the
// Python pipeline drives through ctypes (ladder_tpu_torch/runtime).
// It indexes the record framing once, then assembles shuffled uint8 batches
// with a worker pool, decoding the minimal tf.train.Example wire format
// (features -> feature map entry -> bytes_list value) in place from the
// mapped file. No protobuf or TF dependency.
//
// Record framing: [len u64 LE][masked crc32c(len) u32][payload][crc u32].
// CRCs are not verified on read (matching tf.data defaults for speed).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -msse4.2
//        -o libtfrecord.so tfrecord_reader.cc

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

struct Record {
  uint64_t offset;  // payload start
  uint64_t length;  // payload length
};

// ---- minimal protobuf wire helpers ---------------------------------------

bool read_varint(const uint8_t* buf, uint64_t end, uint64_t& pos,
                 uint64_t& out) {
  uint64_t result = 0;
  int shift = 0;
  while (pos < end && shift < 64) {
    uint8_t b = buf[pos++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Find the first bytes value of feature `key` in a serialized Example.
// Returns pointer+len into buf, or nullptr.
const uint8_t* find_bytes_feature(const uint8_t* buf, uint64_t len,
                                  const char* key, uint64_t key_len,
                                  uint64_t* out_len) {
  // walk: Example.features(1) > Features.feature(1)* > entry{key(1),
  // value(2)} > Feature.bytes_list(1) > BytesList.value(1)
  struct Span { uint64_t start, end; };
  auto walk = [&](uint64_t start, uint64_t end, auto&& visit) {
    uint64_t pos = start;
    while (pos < end) {
      uint64_t tag;
      if (!read_varint(buf, end, pos, tag)) return;
      uint32_t wire = tag & 7;
      uint64_t field = tag >> 3;
      if (wire == 2) {
        uint64_t ln;
        if (!read_varint(buf, end, pos, ln)) return;
        if (pos + ln > end) return;
        visit(field, pos, pos + ln);
        pos += ln;
      } else if (wire == 0) {
        uint64_t v;
        if (!read_varint(buf, end, pos, v)) return;
      } else if (wire == 5) {
        pos += 4;
      } else if (wire == 1) {
        pos += 8;
      } else {
        return;
      }
    }
  };

  const uint8_t* result = nullptr;
  uint64_t result_len = 0;
  walk(0, len, [&](uint64_t f1, uint64_t s1, uint64_t e1) {
    if (f1 != 1 || result) return;                       // Example.features
    walk(s1, e1, [&](uint64_t f2, uint64_t s2, uint64_t e2) {
      if (f2 != 1 || result) return;                     // map entry
      bool key_match = false;
      uint64_t fs = 0, fe = 0;
      walk(s2, e2, [&](uint64_t f3, uint64_t s3, uint64_t e3) {
        if (f3 == 1 && e3 - s3 == key_len &&
            memcmp(buf + s3, key, key_len) == 0)
          key_match = true;
        else if (f3 == 2) { fs = s3; fe = e3; }
      });
      if (!key_match || fs == fe) return;
      walk(fs, fe, [&](uint64_t f4, uint64_t s4, uint64_t e4) {
        if (f4 != 1 || result) return;                   // Feature.bytes_list
        walk(s4, e4, [&](uint64_t f5, uint64_t s5, uint64_t e5) {
          if (f5 == 1 && !result) {                      // BytesList.value
            result = buf + s5;
            result_len = e5 - s5;
          }
        });
      });
    });
  });
  *out_len = result_len;
  return result;
}

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  uint64_t size = 0;
  std::vector<Record> index;
  uint64_t image_bytes = 0;
  std::string key = "X";
  int n_threads = 4;
};

// CRC32C (Castagnoli) — hardware crc32 instruction when available, else a
// byte-table fallback. Used by the Python TFRecord WRITER (data/tfrecord.py)
// for record framing checksums; the pure-Python table loop costs ~9 ms per
// 48 KiB image record, which dominates dataset generation.
uint32_t crc32c_impl(const uint8_t* data, uint64_t n) {
#if defined(__SSE4_2__)
  uint64_t crc = 0xFFFFFFFFu;
  uint64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    memcpy(&chunk, data + i, 8);
    crc = _mm_crc32_u64(crc, chunk);
  }
  uint32_t c = static_cast<uint32_t>(crc);
  for (; i < n; ++i) c = _mm_crc32_u8(c, data[i]);
  return c ^ 0xFFFFFFFFu;
#else
  static uint32_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t v = 0; v < 256; ++v) {
      uint32_t crc = v;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ (crc & 1 ? 0x82F63B78u : 0u);
      table[v] = crc;
    }
  });
  uint32_t crc = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; ++i)
    crc = (crc >> 8) ^ table[(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
#endif
}

}  // namespace

extern "C" {

uint32_t ldr_crc32c(const uint8_t* data, long n) {
  return crc32c_impl(data, static_cast<uint64_t>(n));
}

void* ldr_open(const char* path, long image_bytes, const char* key,
               int n_threads) {
  auto* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) { delete r; return nullptr; }
  struct stat st;
  if (fstat(r->fd, &st) != 0) { close(r->fd); delete r; return nullptr; }
  r->size = static_cast<uint64_t>(st.st_size);
  void* m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
  if (m == MAP_FAILED) { close(r->fd); delete r; return nullptr; }
  r->data = static_cast<const uint8_t*>(m);
  madvise(m, r->size, MADV_WILLNEED);
  r->image_bytes = static_cast<uint64_t>(image_bytes);
  r->key = key ? key : "X";
  r->n_threads = n_threads > 0 ? n_threads : 4;

  // index the record framing in one pass
  uint64_t pos = 0;
  while (pos + 12 <= r->size) {
    uint64_t len;
    memcpy(&len, r->data + pos, 8);  // little-endian host assumed
    uint64_t payload = pos + 12;
    if (payload + len + 4 > r->size) break;
    r->index.push_back({payload, len});
    pos = payload + len + 4;
  }
  return r;
}

long ldr_count(void* handle) {
  return static_cast<long>(static_cast<Reader*>(handle)->index.size());
}

// Decode records idxs[0..n) into out (n * image_bytes). Returns number of
// records decoded successfully.
long ldr_read_batch(void* handle, const long* idxs, long n,
                    unsigned char* out) {
  auto* r = static_cast<Reader*>(handle);
  std::atomic<long> ok{0};
  std::atomic<long> next{0};
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n) return;
      long idx = idxs[i];
      if (idx < 0 || idx >= static_cast<long>(r->index.size())) continue;
      const Record& rec = r->index[idx];
      uint64_t raw_len = 0;
      const uint8_t* raw = find_bytes_feature(
          r->data + rec.offset, rec.length, r->key.c_str(), r->key.size(),
          &raw_len);
      if (!raw || raw_len != r->image_bytes) continue;
      memcpy(out + static_cast<uint64_t>(i) * r->image_bytes, raw,
             r->image_bytes);
      ok.fetch_add(1);
    }
  };
  int nt = std::min<long>(r->n_threads, n);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return ok.load();
}

void ldr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r->data) munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

}  // extern "C"
