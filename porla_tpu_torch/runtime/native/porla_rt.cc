// porla_rt: the native host runtime of porla_tpu_torch.
//
// Covers the roles the reference implements in C/C++ on the host side:
//   - AES-128 (key schedule + ECB batch encrypt): the MAC-complement PRF
//     (reference porla/Client/Client.hpp:423-455, OpenSSL AES_encrypt) and
//     the emp-style AES-CTR PRG that expands block data and audit seeds
//     (reference porla/Utils/prg.h, aes.h). AES-NI when the build enables
//     it (-maes on x86-64), the portable S-box form otherwise.
//   - Batched block-file IO on a pool of threads: the audit path's
//     threaded reads (reference porla/Server/Server.hpp:742-776) and the
//     storage tier's codeword and staging files (reference
//     porla/Utils/utils.h:473-638, ThreadPool.h), and the deletion of a
//     pass's consumed staging files.
//
// A plain C ABI, bound with ctypes (runtime/lib.py), which builds this
// file with g++ at first use.

#include <fcntl.h>
#include <pthread.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(__AES__) && defined(__x86_64__)
#include <wmmintrin.h>
#define PORLA_AESNI 1
#endif

namespace {

// ---------------------------------------------------------------------------
// Portable AES-128 (encrypt only), S-box lookups.
// ---------------------------------------------------------------------------

static const uint8_t kSbox[256] = {
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,
    0xab,0x76,0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,
    0x9c,0xa4,0x72,0xc0,0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,
    0xe5,0xf1,0x71,0xd8,0x31,0x15,0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,
    0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,0x09,0x83,0x2c,0x1a,0x1b,0x6e,
    0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,0x53,0xd1,0x00,0xed,
    0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,0xd0,0xef,
    0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,
    0xf3,0xd2,0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,
    0x64,0x5d,0x19,0x73,0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,
    0xb8,0x14,0xde,0x5e,0x0b,0xdb,0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,
    0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,0xe7,0xc8,0x37,0x6d,0x8d,0xd5,
    0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,0xba,0x78,0x25,0x2e,
    0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,0x70,0x3e,
    0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,
    0x28,0xdf,0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,
    0xb0,0x54,0xbb,0x16};

inline uint8_t xtime(uint8_t x) {
  return static_cast<uint8_t>((x << 1) ^ ((x >> 7) * 0x1b));
}

struct AesKey {
  uint8_t rk[11][16];
};

void aes128_expand(const uint8_t key[16], AesKey* out) {
  std::memcpy(out->rk[0], key, 16);
  uint8_t rcon = 1;
  for (int r = 1; r <= 10; ++r) {
    uint8_t* prev = out->rk[r - 1];
    uint8_t* cur = out->rk[r];
    uint8_t t[4] = {prev[13], prev[14], prev[15], prev[12]};
    for (int i = 0; i < 4; ++i) t[i] = kSbox[t[i]];
    t[0] ^= rcon;
    rcon = xtime(rcon);
    for (int i = 0; i < 4; ++i) cur[i] = prev[i] ^ t[i];
    for (int i = 4; i < 16; ++i) cur[i] = prev[i] ^ cur[i - 4];
  }
}

void aes128_encrypt_block_sw(const AesKey& k, const uint8_t in[16],
                             uint8_t out[16]) {
  uint8_t s[16];
  for (int i = 0; i < 16; ++i) s[i] = in[i] ^ k.rk[0][i];
  for (int round = 1; round <= 10; ++round) {
    uint8_t t[16];
    // SubBytes + ShiftRows
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 4; ++r)
        t[4 * c + r] = kSbox[s[4 * ((c + r) & 3) + r]];
    if (round < 10) {  // MixColumns
      for (int c = 0; c < 4; ++c) {
        uint8_t* p = t + 4 * c;
        uint8_t a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
        uint8_t x = a0 ^ a1 ^ a2 ^ a3;
        p[0] = a0 ^ x ^ xtime(a0 ^ a1);
        p[1] = a1 ^ x ^ xtime(a1 ^ a2);
        p[2] = a2 ^ x ^ xtime(a2 ^ a3);
        p[3] = a3 ^ x ^ xtime(a3 ^ a0);
      }
    }
    for (int i = 0; i < 16; ++i) s[i] = t[i] ^ k.rk[round][i];
  }
  std::memcpy(out, s, 16);
}

#ifdef PORLA_AESNI
struct AesKeyNI {
  __m128i rk[11];
};

inline __m128i aes_expand_step(__m128i key, __m128i kg) {
  kg = _mm_shuffle_epi32(kg, _MM_SHUFFLE(3, 3, 3, 3));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, kg);
}

void aes128_expand_ni(const uint8_t key[16], AesKeyNI* out) {
  __m128i k = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
  out->rk[0] = k;
#define EXP(i, rcon) \
  k = aes_expand_step(k, _mm_aeskeygenassist_si128(k, rcon)); out->rk[i] = k;
  EXP(1, 0x01) EXP(2, 0x02) EXP(3, 0x04) EXP(4, 0x08) EXP(5, 0x10)
  EXP(6, 0x20) EXP(7, 0x40) EXP(8, 0x80) EXP(9, 0x1b) EXP(10, 0x36)
#undef EXP
}
#endif

// Workers kept for the life of the process: a batch of files wakes them
// in place of starting threads of its own, since on a sandboxed host
// starting a thread costs more than reading a small file (there, the 2 x 32
// thread starts of an audit's two batched reads took about 18 ms and the
// 128 reads behind them under 2: PERF.md section 6). One batch runs at a
// time; its caller works too.
class Pool {
 public:
  // Run fn(i) for i in [0, n) on `threads` workers in all (the caller
  // included), each taking the next index from a shared counter.
  void run(int64_t n, int64_t threads, const std::function<void(int64_t)>& fn) {
    std::lock_guard<std::mutex> one_batch(batch_mu_);
    std::unique_lock<std::mutex> lk(mu_);
    while (static_cast<int64_t>(workers_.size()) < threads - 1) {
      int64_t id = static_cast<int64_t>(workers_.size());
      workers_.emplace_back([this, id, seen = gen_] { loop(id, seen); });
    }
    job_ = &fn;
    n_ = n;
    next_.store(0);
    want_ = active_ = threads - 1;
    ++gen_;
    lk.unlock();
    wake_.notify_all();
    for (int64_t i; (i = next_.fetch_add(1)) < n;) fn(i);
    lk.lock();
    done_.wait(lk, [&] { return active_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop(int64_t id, int64_t seen) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      if (id >= want_) continue;
      lk.unlock();
      for (int64_t i; (i = next_.fetch_add(1)) < n_;) (*job_)(i);
      lk.lock();
      if (--active_ == 0) done_.notify_one();
    }
  }

  std::mutex batch_mu_, mu_;
  std::condition_variable wake_, done_;
  std::vector<std::thread> workers_;
  const std::function<void(int64_t)>* job_ = nullptr;
  int64_t n_ = 0, want_ = 0, active_ = 0, gen_ = 0;
  std::atomic<int64_t> next_{0};
};

std::atomic<Pool*>& process_pool() {
  static std::atomic<Pool*> p{nullptr};
  return p;
}

// The process's pool, made at first use and never destroyed (its workers
// wait until the process ends). A forked child has none of its parent's
// threads, so it forgets the pool and makes its own.
Pool* pool() {
  static const int forget_on_fork = pthread_atfork(
      nullptr, nullptr, [] { process_pool().store(nullptr); });
  (void)forget_on_fork;
  Pool* p = process_pool().load();
  if (!p) {
    Pool* fresh = new Pool;
    if (process_pool().compare_exchange_strong(p, fresh))
      p = fresh;
    else
      delete fresh;
  }
  return p;
}

// Run fn(i, dir, name) for each of the n NUL-separated paths on `threads`
// workers (8 when not positive, never more than n). Where every path lies
// in one directory, that directory is opened once and `name` is the path's
// last component under `dir`, so that a file's open walks one component;
// otherwise `dir` is AT_FDCWD and `name` the whole path. Returns how many
// calls returned true.
template <class Fn>
int64_t for_each_file(const char* paths, int64_t n, int32_t threads, Fn fn) {
  std::vector<const char*> ps(n);
  for (int64_t i = 0; i < n; ++i) {
    ps[i] = paths;
    paths += std::strlen(paths) + 1;
  }
  int dir = AT_FDCWD;
  size_t cut = 0;
  if (n > 0) {
    const char* slash = std::strrchr(ps[0], '/');
    cut = slash ? static_cast<size_t>(slash - ps[0]) + 1 : 0;
    for (int64_t i = 1; cut && i < n; ++i)
      if (std::strncmp(ps[i], ps[0], cut) != 0 ||
          std::strchr(ps[i] + cut, '/'))
        cut = 0;
    if (cut) {
      std::string d(ps[0], cut);
      dir = open(d.c_str(), O_RDONLY | O_DIRECTORY | O_CLOEXEC);
      if (dir < 0) dir = AT_FDCWD, cut = 0;
    }
  }
  std::atomic<int64_t> ok{0};
  int64_t nt = threads > 0 ? threads : 8;
  if (nt > n) nt = n;
  auto one = [&](int64_t i) {
    if (fn(i, dir, ps[i] + cut)) ok.fetch_add(1);
  };
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) one(i);
  } else {
    pool()->run(n, nt, one);
  }
  if (dir != AT_FDCWD) close(dir);
  return ok.load();
}

// Move exactly `size` bytes with pread/pwrite at offset 0; false on a
// short file or an error.
template <class Op, class Buf>
bool whole(Op op, int fd, Buf buf, size_t size) {
  size_t done = 0;
  while (done < size) {
    ssize_t k = op(fd, buf + done, size - done, static_cast<off_t>(done));
    if (k < 0 && errno == EINTR) continue;
    if (k <= 0) return false;
    done += static_cast<size_t>(k);
  }
  return true;
}

}  // namespace

extern "C" {

// AES-128 ECB: encrypt nblocks 16-byte blocks.
void porla_aes128_ecb(const uint8_t key[16], const uint8_t* in, uint8_t* out,
                      int64_t nblocks) {
#ifdef PORLA_AESNI
  AesKeyNI k;
  aes128_expand_ni(key, &k);
  for (int64_t i = 0; i < nblocks; ++i) {
    __m128i b = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(in + 16 * i));
    b = _mm_xor_si128(b, k.rk[0]);
    for (int r = 1; r < 10; ++r) b = _mm_aesenc_si128(b, k.rk[r]);
    b = _mm_aesenclast_si128(b, k.rk[10]);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * i), b);
  }
#else
  AesKey k;
  aes128_expand(key, &k);
  for (int64_t i = 0; i < nblocks; ++i)
    aes128_encrypt_block_sw(k, in + 16 * i, out + 16 * i);
#endif
}

// emp-compatible PRG: out = AES_k(makeBlock(0, counter+i)) for i<nblocks.
void porla_prg_expand(const uint8_t key[16], uint64_t counter, uint8_t* out,
                      int64_t nblocks) {
  std::vector<uint8_t> pts(static_cast<size_t>(nblocks) * 16, 0);
  for (int64_t i = 0; i < nblocks; ++i) {
    uint64_t c = counter + static_cast<uint64_t>(i);
    std::memcpy(&pts[16 * i], &c, 8);  // little-endian low half
  }
  porla_aes128_ecb(key, pts.data(), out, nblocks);
}

// Read `n` files of exactly `record_size` bytes each into a contiguous
// buffer using `threads` workers. paths: concatenated NUL-separated.
// Returns number of files read successfully.
int64_t porla_read_files(const char* paths, int64_t n, int64_t record_size,
                         uint8_t* out, int32_t threads) {
  size_t size = static_cast<size_t>(record_size);
  return for_each_file(paths, n, threads,
                       [=](int64_t i, int dir, const char* name) {
    int fd = openat(dir, name, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return false;
    bool ok = whole(pread, fd, out + i * record_size, size);
    close(fd);
    return ok;
  });
}

// Write `n` equally-sized records from a contiguous buffer to files.
int64_t porla_write_files(const char* paths, int64_t n, int64_t record_size,
                          const uint8_t* data, int32_t threads) {
  size_t size = static_cast<size_t>(record_size);
  return for_each_file(paths, n, threads,
                       [=](int64_t i, int dir, const char* name) {
    int fd = openat(dir, name, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC,
                    0666);
    if (fd < 0) return false;
    bool ok = whole(pwrite, fd, data + i * record_size, size);
    return close(fd) == 0 && ok;
  });
}

// Delete `n` files using `threads` workers; a missing file counts as
// deleted. Returns the number of files that are gone.
int64_t porla_delete_files(const char* paths, int64_t n, int32_t threads) {
  return for_each_file(paths, n, threads,
                       [](int64_t, int dir, const char* name) {
    return unlinkat(dir, name, 0) == 0 || errno == ENOENT;
  });
}

}  // extern "C"
