// dabhost: native host-side runtime for dabtools_tpu.
//
// The reference (linuxstb/dabtools) is pure C; its byte-level hot paths
// (CRCs in upstream:dab.c, the IQ FIFO in upstream:sdr_fifo.c, ETI frame
// assembly in upstream:dab.c eti_build, FSYNC hunting in upstream:
// eti2mpa.c) have native equivalents here so the TPU framework's host side
// is not Python-bound at production stream rates.  Loaded via ctypes
// (dabtools_tpu/utils/native.py); every function has a NumPy fallback and
// the test suite cross-checks the two.
//
// Build: make -C dabtools_tpu/native   (produces libdabhost.so)

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------- CRCs
static uint16_t g_ccitt[256];
static uint16_t g_fire[256];
static uint8_t g_prbs[8192];
static bool g_init_done = false;

static void make_table(uint16_t poly, uint16_t *table) {
  for (int byte = 0; byte < 256; ++byte) {
    uint16_t crc = (uint16_t)(byte << 8);
    for (int i = 0; i < 8; ++i)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ poly)
                           : (uint16_t)(crc << 1);
    table[byte] = crc;
  }
}

void dabhost_init(void) {
  if (g_init_done) return;
  make_table(0x1021, g_ccitt);
  make_table(0x782F, g_fire);
  // Energy-dispersal PRBS (x^9+x^5+1, all-ones init), packed MSB-first.
  uint16_t reg = 0x1FF;
  for (size_t i = 0; i < sizeof(g_prbs); ++i) {
    uint8_t byte = 0;
    for (int b = 0; b < 8; ++b) {
      uint8_t bit = ((reg >> 8) ^ (reg >> 4)) & 1;
      byte = (uint8_t)((byte << 1) | bit);
      reg = (uint16_t)(((reg << 1) | bit) & 0x1FF);
    }
    g_prbs[i] = byte;
  }
  g_init_done = true;
}

// CRC-16/CCITT, init 0xFFFF, final complement (DAB convention).
uint16_t dabhost_crc16_ccitt(const uint8_t *data, size_t len) {
  uint16_t crc = 0xFFFF;
  for (size_t i = 0; i < len; ++i)
    crc = (uint16_t)((crc << 8) ^ g_ccitt[(crc >> 8) ^ data[i]]);
  return (uint16_t)(crc ^ 0xFFFF);
}

// Batch validity check: for each of `n` contiguous `block_len`-byte
// blocks, ok[i] = 1 iff the trailing 2 bytes are the valid DAB CRC of the
// rest.  One call per device block replaces 12-per-frame Python/ctypes
// round trips in the receiver's FIB loop (host hot path at 1000x+).
void dabhost_crc16_ok_batch(const uint8_t *blocks, size_t n,
                            size_t block_len, uint8_t *ok) {
  for (size_t i = 0; i < n; ++i) {
    const uint8_t *b = blocks + i * block_len;
    uint16_t crc = dabhost_crc16_ccitt(b, block_len - 2);
    ok[i] = (crc == (uint16_t)((b[block_len - 2] << 8) | b[block_len - 1]))
                ? 1 : 0;
  }
}

// DAB+ firecode (init 0, no complement).
uint16_t dabhost_firecode(const uint8_t *data, size_t len) {
  uint16_t crc = 0;
  for (size_t i = 0; i < len; ++i)
    crc = (uint16_t)((crc << 8) ^ g_fire[(crc >> 8) ^ data[i]]);
  return crc;
}

// XOR buf with the energy-dispersal PRBS (byte-aligned, restart at 0).
void dabhost_prbs_xor(uint8_t *buf, size_t len) {
  size_t n = len < sizeof(g_prbs) ? len : sizeof(g_prbs);
  for (size_t i = 0; i < n; ++i) buf[i] ^= g_prbs[i];
}

// --------------------------------------------------------------- ETI(NI)
// Find the first plausible ETI frame start at/after `start`: byte offset
// whose following 3 bytes are FSYNC or its complement (offset points at
// the ERR byte). Returns -1 if none.
int64_t dabhost_eti_find_fsync(const uint8_t *buf, size_t len, size_t start) {
  if (len < 4) return -1;
  for (size_t i = start; i + 4 <= len; ++i) {
    uint32_t w = ((uint32_t)buf[i + 1] << 16) | ((uint32_t)buf[i + 2] << 8)
                 | buf[i + 3];
    if (w == 0x073AB6u || w == 0xF8C549u) return (int64_t)i;
  }
  return -1;
}

// Assemble one 6144-byte ETI(NI) frame.  stc_words: n_streams packed
// 4-byte STC entries (already encoded); sub-channel payloads are
// concatenated in `mst_data` (after the FIC).  Returns frame length (6144)
// or -1 on overflow.
int64_t dabhost_eti_build(uint8_t fct, uint8_t fp, uint8_t err, uint8_t mid,
                          const uint8_t *stc, size_t n_streams,
                          const uint8_t *fic, size_t fic_len,
                          const uint8_t *subch, size_t subch_len,
                          uint8_t *out /* 6144 bytes */) {
  const size_t kFrame = 6144;
  size_t mst_len = fic_len + subch_len;
  size_t fl_words = (4 * n_streams + 4 + mst_len) / 4;
  size_t total = 4 /*ERR+FSYNC*/ + 4 /*FC*/ + 4 * n_streams + 4 /*EOH*/
                 + mst_len + 4 /*EOF*/ + 4 /*TIST*/;
  if (total > kFrame || fl_words > 0x7FF) return -1;

  uint8_t *p = out;
  *p++ = err;
  uint32_t fsync = (fct % 2 == 0) ? 0x073AB6u : 0xF8C549u;
  *p++ = (uint8_t)(fsync >> 16);
  *p++ = (uint8_t)(fsync >> 8);
  *p++ = (uint8_t)(fsync);

  uint8_t *fc = p;
  *p++ = fct;
  *p++ = (uint8_t)(0x80 | (n_streams & 0x7F));  // FICF=1 | NST
  // FP is a continuous mod-8 counter maintained by the caller (FCT wraps
  // mod 250, which is not a multiple of 8; FCT parity == frame parity
  // though, so FSYNC alternation from fct%2 is exact).
  *p++ = (uint8_t)(((fp & 7) << 5) | ((mid & 3) << 3)
                   | ((fl_words >> 8) & 0x07));
  *p++ = (uint8_t)(fl_words & 0xFF);

  memcpy(p, stc, 4 * n_streams);
  p += 4 * n_streams;

  *p++ = 0xFF; *p++ = 0xFF;                      // MNSC
  uint16_t hcrc = dabhost_crc16_ccitt(fc, 4 + 4 * n_streams + 2);
  *p++ = (uint8_t)(hcrc >> 8);
  *p++ = (uint8_t)(hcrc);

  uint8_t *mst = p;
  memcpy(p, fic, fic_len); p += fic_len;
  memcpy(p, subch, subch_len); p += subch_len;

  uint16_t mcrc = dabhost_crc16_ccitt(mst, mst_len);
  *p++ = (uint8_t)(mcrc >> 8);
  *p++ = (uint8_t)(mcrc);
  *p++ = 0xFF; *p++ = 0xFF;                      // RFU
  *p++ = 0xFF; *p++ = 0xFF; *p++ = 0xFF; *p++ = 0xFF;  // TIST unused

  memset(p, 0x55, kFrame - (size_t)(p - out));
  return (int64_t)kFrame;
}

// Batched frame assembly: one crossing of the ctypes boundary per device
// block instead of per 24 ms frame (the e2e host hot path).  Frame i uses
// fct = (fct0 + i) mod 250, fp = (fp0 + i) mod 8, err[i]; FIC/sub-channel
// payloads are the concatenations of the per-frame slices.  Returns
// n_frames * 6144 or -1 on any overflow.
int64_t dabhost_eti_build_batch(size_t n_frames, uint8_t fct0, uint8_t fp0,
                                const uint8_t *err, uint8_t mid,
                                const uint8_t *stc, size_t n_streams,
                                const uint8_t *fic_all, size_t fic_len,
                                const uint8_t *subch_all, size_t subch_len,
                                uint8_t *out /* n_frames * 6144 */) {
  for (size_t i = 0; i < n_frames; ++i) {
    int64_t r = dabhost_eti_build(
        (uint8_t)((fct0 + i) % 250), (uint8_t)((fp0 + i) % 8), err[i], mid,
        stc, n_streams, fic_all + i * fic_len, fic_len,
        subch_all + i * subch_len, subch_len, out + i * 6144);
    if (r != 6144) return -1;
  }
  return (int64_t)(n_frames * 6144);
}

// ------------------------------------------------------- IQ conversion
// RTL-SDR style unsigned 8-bit interleaved IQ -> interleaved float32.
void dabhost_u8_to_cf32(const uint8_t *in, float *out, size_t n_values,
                        float scale) {
  const float inv = 1.0f / scale;
  for (size_t i = 0; i < n_values; ++i)
    out[i] = ((float)in[i] - 128.0f) * inv;
}

// --------------------------------------------------- SPSC IQ ring buffer
// Reference counterpart: upstream:sdr_fifo.c (R4), lock-free here.
typedef struct {
  uint8_t *data;
  size_t capacity;                 // bytes, power of two
  std::atomic<size_t> head;        // write position (producer)
  std::atomic<size_t> tail;        // read position (consumer)
  std::atomic<uint64_t> dropped;   // bytes dropped on overflow
} dab_ring;

dab_ring *dabhost_ring_create(size_t capacity_pow2) {
  dab_ring *rb = (dab_ring *)calloc(1, sizeof(dab_ring));
  if (!rb) return nullptr;
  rb->data = (uint8_t *)malloc(capacity_pow2);
  if (!rb->data) { free(rb); return nullptr; }
  rb->capacity = capacity_pow2;
  rb->head.store(0); rb->tail.store(0); rb->dropped.store(0);
  return rb;
}

void dabhost_ring_free(dab_ring *rb) {
  if (rb) { free(rb->data); free(rb); }
}

size_t dabhost_ring_fill(const dab_ring *rb) {
  return rb->head.load(std::memory_order_acquire)
         - rb->tail.load(std::memory_order_acquire);
}

// Producer: returns bytes written (drops the excess, counting it).
size_t dabhost_ring_write(dab_ring *rb, const uint8_t *src, size_t len) {
  size_t head = rb->head.load(std::memory_order_relaxed);
  size_t tail = rb->tail.load(std::memory_order_acquire);
  size_t space = rb->capacity - (head - tail);
  size_t n = len < space ? len : space;
  for (size_t i = 0; i < n; ++i)
    rb->data[(head + i) & (rb->capacity - 1)] = src[i];
  rb->head.store(head + n, std::memory_order_release);
  if (n < len) rb->dropped.fetch_add(len - n);
  return n;
}

// Consumer: returns bytes read.
size_t dabhost_ring_read(dab_ring *rb, uint8_t *dst, size_t len) {
  size_t tail = rb->tail.load(std::memory_order_relaxed);
  size_t head = rb->head.load(std::memory_order_acquire);
  size_t avail = head - tail;
  size_t n = len < avail ? len : avail;
  for (size_t i = 0; i < n; ++i)
    dst[i] = rb->data[(tail + i) & (rb->capacity - 1)];
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

uint64_t dabhost_ring_dropped(const dab_ring *rb) {
  return rb->dropped.load();
}

}  // extern "C"
