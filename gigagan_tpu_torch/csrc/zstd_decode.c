/* A zstd frame decoder (RFC 8878) and CRC-32C, host C with a plain C
 * interface, loaded with ctypes by gigagan_tpu_torch/utils/zstd.py.
 *
 *   int64_t zstd_decoded_size(const uint8_t *src, size_t n)
 *       the sum of the frames' Frame_Content_Size, or a negative code
 *       (ZE_UNKNOWN_SIZE when a frame does not declare its size);
 *   int64_t zstd_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap)
 *       decodes every frame of src (zstd and skippable) into dst, returns
 *       the bytes written or a negative code;
 *   const char *zstd_error_name(int64_t code);
 *   uint32_t crc32c(const uint8_t *src, size_t n).
 *
 * Blocks raw, RLE and compressed; literals raw, RLE, Huffman (one and four
 * streams, with the previous table for treeless literals); sequences with
 * predefined, RLE, FSE and repeat tables; the repeat offsets; the frame's
 * XXH64 content checksum, verified when the frame carries one.  A frame
 * that names a dictionary is refused (ZE_DICTIONARY).  Huffman and FSE
 * decode through tables, one lookup per symbol; the four Huffman streams
 * are decoded interleaved.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ZE_TRUNCATED (-1)
#define ZE_MAGIC (-2)
#define ZE_CORRUPT (-3)
#define ZE_DST_TOO_SMALL (-4)
#define ZE_CHECKSUM (-5)
#define ZE_DICTIONARY (-6)
#define ZE_RESERVED (-7)
#define ZE_UNKNOWN_SIZE (-8)
#define ZE_NO_MEMORY (-9)

#define BLOCK_MAX (128 * 1024)
#define HUF_LOG_MAX 12
#define LL_LOG_MAX 9
#define ML_LOG_MAX 9
#define OF_LOG_MAX 8
#define LL_MAX 35
#define ML_MAX 52
#define OF_MAX 31

const char *zstd_error_name(int64_t code) {
  switch (code) {
    case ZE_TRUNCATED: return "truncated input";
    case ZE_MAGIC: return "not a zstd frame (bad magic number)";
    case ZE_CORRUPT: return "corrupt data";
    case ZE_DST_TOO_SMALL: return "output larger than the given capacity";
    case ZE_CHECKSUM: return "content checksum mismatch";
    case ZE_DICTIONARY: return "the frame needs a dictionary (not supported)";
    case ZE_RESERVED: return "a reserved field is set";
    case ZE_UNKNOWN_SIZE: return "a frame does not declare its content size";
    case ZE_NO_MEMORY: return "out of memory";
    default: return code >= 0 ? "no error" : "unknown error";
  }
}

static inline uint32_t rd16(const uint8_t *p) { return p[0] | (uint32_t)p[1] << 8; }
static inline uint32_t rd24(const uint8_t *p) { return rd16(p) | (uint32_t)p[2] << 16; }
static inline uint32_t rd32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v; /* little-endian hosts only (x86-64, aarch64) */
}
static inline uint64_t rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

/* ------------------------------------------------------------ xxh64 */

#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl64(acc + in * P2, 31) * P1;
}
static inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

static uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = (uint64_t)0 - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xxh_round(v1, rd64(p));
      v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16));
      v4 = xxh_round(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)n;
  for (; p + 8 <= end; p += 8) h = rotl64(h ^ xxh_round(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl64(h ^ (uint64_t)rd32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl64(h ^ (uint64_t)(*p) * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

/* ------------------------------------------------------------ crc32c */

static uint32_t crc_table[8][256];
static int crc_ready;

static void crc_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  crc_ready = 1; /* idempotent: racing first calls write the same table */
}

uint32_t crc32c(const uint8_t *p, size_t n) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) { /* slicing by 8 */
    uint64_t v = rd64(p) ^ c;
    c = crc_table[7][v & 0xFF] ^ crc_table[6][(v >> 8) & 0xFF] ^
        crc_table[5][(v >> 16) & 0xFF] ^ crc_table[4][(v >> 24) & 0xFF] ^
        crc_table[3][(v >> 32) & 0xFF] ^ crc_table[2][(v >> 40) & 0xFF] ^
        crc_table[1][(v >> 48) & 0xFF] ^ crc_table[0][v >> 56];
  }
  for (; n; n--, p++) c = (c >> 8) ^ crc_table[0][(c ^ *p) & 0xFF];
  return ~c;
}

/* ------------------------------------------------- backward bit reader
 * zstd's entropy streams are read from their last byte towards their
 * first; the last byte's highest set bit marks where they start.  `c`
 * holds the 8 bytes at `p`, `used` counts the bits already read from its
 * top.  Bits past the stream's start read as zeros; `bits_left` going
 * negative is an overflow. */

typedef struct {
  uint64_t c;
  unsigned used;
  const uint8_t *p, *start;
} BitR;

static int bit_init(BitR *b, const uint8_t *src, size_t n) {
  if (n == 0 || src[n - 1] == 0) return ZE_CORRUPT;
  b->start = src;
  unsigned pad = 8 - highbit(src[n - 1]);
  if (n >= 8) {
    b->p = src + n - 8;
    b->c = rd64(b->p);
    b->used = pad;
  } else {
    b->p = src;
    b->c = 0;
    for (size_t i = 0; i < n; i++) b->c |= (uint64_t)src[i] << (8 * i);
    b->used = pad + 8 * (unsigned)(8 - n);
  }
  return 0;
}

static inline int64_t bits_left(const BitR *b) {
  return (int64_t)(b->p - b->start) * 8 + 64 - (int64_t)b->used;
}

static inline void bit_reload(BitR *b) {
  if (b->p >= b->start + 8) {
    b->p -= b->used >> 3;
    b->used &= 7;
    b->c = rd64(b->p);
  } else if (b->p > b->start) {
    size_t k = b->used >> 3;
    if (k > (size_t)(b->p - b->start)) k = (size_t)(b->p - b->start);
    b->p -= k;
    b->used -= 8 * (unsigned)k;
    b->c = rd64(b->p);
  }
}

/* n <= 63 bits; zeros past the start */
static inline uint64_t bit_peek(const BitR *b, unsigned n) {
  if (b->used >= 64) return 0;
  return ((b->c << b->used) >> 1) >> (63 - n);
}

static inline uint64_t bit_read(BitR *b, unsigned n) {
  uint64_t v = bit_peek(b, n);
  b->used += n;
  return v;
}

/* a peek with the container known to be full (used + n <= 64, n >= 1) */
static inline unsigned bit_peek_fast(const BitR *b, unsigned n) {
  return (unsigned)((b->c << b->used) >> (64 - n));
}

/* ------------------------------------------------------------- FSE */

typedef struct {
  uint16_t base; /* the next state is base + the bits read */
  uint8_t sym, nb;
} FseE;

/* An FSE table description (forward bit order) → normalized counts;
 * returns the bytes it took, or a negative code. */
static int64_t fse_read_ncount(const uint8_t *src, size_t n, int16_t *norm, int *max_sym,
                               int *log, int log_max) {
  size_t bitpos = 0;
  if (n == 0) return ZE_TRUNCATED;
  int al = (src[0] & 15) + 5;
  if (al > log_max) return ZE_CORRUPT;
  bitpos = 4;
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1;
  int sym = 0, limit = *max_sym, prev0 = 0;
  while (remaining > 1) {
    if (sym > limit) return ZE_CORRUPT;
    if (prev0) {
      int rep;
      do {
        if ((bitpos >> 3) >= n) return ZE_TRUNCATED;
        rep = (int)((src[bitpos >> 3] | (bitpos / 8 + 1 < n ? src[bitpos / 8 + 1] << 8 : 0)) >>
                    (bitpos & 7)) & 3;
        bitpos += 2;
        for (int i = 0; i < rep; i++) {
          if (sym > limit) return ZE_CORRUPT;
          norm[sym++] = 0;
        }
      } while (rep == 3);
      if (sym > limit) return ZE_CORRUPT;
    }
    if ((bitpos >> 3) >= n) return ZE_TRUNCATED;
    uint32_t v = 0;
    for (int i = 0; i < 4 && (bitpos >> 3) + i < n; i++)
      v |= (uint32_t)src[(bitpos >> 3) + i] << (8 * i);
    v >>= bitpos & 7;
    int max = 2 * threshold - 1 - remaining, count;
    if ((int)(v & (threshold - 1)) < max) {
      count = (int)(v & (threshold - 1));
      bitpos += nbits - 1;
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bitpos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return ZE_CORRUPT;
  size_t used = (bitpos + 7) >> 3;
  if (used > n) return ZE_TRUNCATED;
  *max_sym = sym - 1;
  *log = al;
  return (int64_t)used;
}

static int fse_build(FseE *t, const int16_t *norm, int max_sym, int log) {
  int size = 1 << log, high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      t[high--].sym = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s <= max_sym; s++)
    for (int i = 0; i < norm[s]; i++) {
      t[pos].sym = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return ZE_CORRUPT;
  for (int u = 0; u < size; u++) {
    uint16_t x = next[t[u].sym]++;
    int nb = log - highbit(x);
    t[u].nb = (uint8_t)nb;
    t[u].base = (uint16_t)((x << nb) - size);
  }
  return 0;
}

/* ---------------------------------------------------------- Huffman */

typedef struct {
  uint8_t sym, nb;
} HufE;

typedef struct {
  HufE t[1 << HUF_LOG_MAX];
  int log; /* 0: no table yet */
} Huf;

/* A Huffman tree description → the decoding table; returns the bytes it
 * took, or a negative code. */
static int64_t huf_read(Huf *h, const uint8_t *src, size_t n) {
  uint8_t w[256];
  int nw = 0;
  size_t took;
  if (n < 1) return ZE_TRUNCATED;
  int head = src[0];
  if (head >= 128) { /* 4-bit weights */
    nw = head - 127;
    took = 1 + (size_t)(nw + 1) / 2;
    if (took > n) return ZE_TRUNCATED;
    for (int i = 0; i < nw; i++) w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
  } else { /* FSE-compressed weights, two interleaved states */
    took = 1 + (size_t)head;
    if (took > n || head == 0) return head == 0 ? ZE_CORRUPT : ZE_TRUNCATED;
    int16_t norm[256];
    int max_sym = 255, log;
    int64_t k = fse_read_ncount(src + 1, head, norm, &max_sym, &log, 6);
    if (k < 0) return k;
    FseE t[64];
    if (fse_build(t, norm, max_sym, log)) return ZE_CORRUPT;
    BitR b;
    if ((size_t)k >= (size_t)head) return ZE_CORRUPT;
    if (bit_init(&b, src + 1 + k, head - k)) return ZE_CORRUPT;
    unsigned s1 = (unsigned)bit_read(&b, log), s2 = (unsigned)bit_read(&b, log);
    bit_reload(&b);
    if (bits_left(&b) < 0) return ZE_CORRUPT;
    for (;;) {
      if (nw > 253) return ZE_CORRUPT;
      w[nw++] = t[s1].sym;
      s1 = t[s1].base + (unsigned)bit_read(&b, t[s1].nb);
      bit_reload(&b);
      if (bits_left(&b) < 0) {
        w[nw++] = t[s2].sym;
        break;
      }
      w[nw++] = t[s2].sym;
      s2 = t[s2].base + (unsigned)bit_read(&b, t[s2].nb);
      bit_reload(&b);
      if (bits_left(&b) < 0) {
        w[nw++] = t[s1].sym;
        break;
      }
    }
  }
  /* the last symbol's weight is implied: the sum must reach a power of 2 */
  uint32_t rank[HUF_LOG_MAX + 2] = {0}, sum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > HUF_LOG_MAX) return ZE_CORRUPT;
    rank[w[i]]++;
    sum += (1u << w[i]) >> 1;
  }
  if (sum == 0 || nw > 255) return ZE_CORRUPT;
  int log = highbit(sum) + 1;
  if (log > HUF_LOG_MAX) return ZE_CORRUPT;
  uint32_t rest = (1u << log) - sum;
  if (rest & (rest - 1)) return ZE_CORRUPT;
  w[nw] = (uint8_t)(highbit(rest) + 1);
  rank[w[nw]]++;
  nw++;
  if (rank[1] < 2 || (rank[1] & 1)) return ZE_CORRUPT;
  /* fill by weight ascending, then by symbol */
  uint32_t start[HUF_LOG_MAX + 2], next = 0;
  for (int k = 1; k <= log; k++) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  for (int s = 0; s < nw; s++) {
    int wt = w[s];
    if (!wt) continue;
    uint32_t len = (1u << wt) >> 1;
    HufE e = {(uint8_t)s, (uint8_t)(log + 1 - wt)};
    for (uint32_t u = start[wt]; u < start[wt] + len; u++) h->t[u] = e;
    start[wt] += len;
  }
  h->log = log;
  return (int64_t)took;
}

static int huf_stream(const Huf *h, const uint8_t *src, size_t n, uint8_t *op, uint8_t *oend) {
  BitR b;
  if (bit_init(&b, src, n)) return ZE_CORRUPT;
  const int log = h->log, k = 57 / log;
  const HufE *t = h->t;
  for (;;) { /* the container holds 57 bits or more: k symbols per load */
    bit_reload(&b);
    if (b.p < b.start + 8 || oend - op < k) break;
    for (int i = 0; i < k; i++) {
      HufE e = t[bit_peek_fast(&b, log)];
      b.used += e.nb;
      *op++ = e.sym;
    }
  }
  while (op < oend) {
    bit_reload(&b);
    HufE e = t[bit_peek(&b, log)];
    b.used += e.nb;
    *op++ = e.sym;
  }
  bit_reload(&b);
  return bits_left(&b) == 0 ? 0 : ZE_CORRUPT;
}

static int huf_4streams(const Huf *h, const uint8_t *src, size_t n, uint8_t *dst, size_t size) {
  if (n < 10) return ZE_CORRUPT;
  size_t s1 = rd16(src), s2 = rd16(src + 2), s3 = rd16(src + 4);
  if (6 + s1 + s2 + s3 > n) return ZE_CORRUPT;
  size_t seg = (size + 3) / 4;
  if (3 * seg > size) return ZE_CORRUPT;
  const uint8_t *ip[4] = {src + 6, src + 6 + s1, src + 6 + s1 + s2, src + 6 + s1 + s2 + s3};
  size_t len[4] = {s1, s2, s3, n - 6 - s1 - s2 - s3};
  uint8_t *op[4], *oend[4];
  BitR b[4];
  for (int s = 0; s < 4; s++) {
    op[s] = dst + s * seg;
    oend[s] = s < 3 ? op[s] + seg : dst + size;
    if (bit_init(&b[s], ip[s], len[s])) return ZE_CORRUPT;
  }
  const int log = h->log, k = 57 / log;
  const HufE *t = h->t;
  for (;;) { /* the four streams interleaved while each holds 8 bytes more */
    int ok = 1;
    for (int s = 0; s < 4; s++) {
      bit_reload(&b[s]);
      ok &= (b[s].p >= b[s].start + 8) & (oend[s] - op[s] >= k);
    }
    if (!ok) break;
    /* the streams' state in locals, so that it stays in registers */
    const uint64_t c0 = b[0].c, c1 = b[1].c, c2 = b[2].c, c3 = b[3].c;
    unsigned u0 = b[0].used, u1 = b[1].used, u2 = b[2].used, u3 = b[3].used;
    uint8_t *o0 = op[0], *o1 = op[1], *o2 = op[2], *o3 = op[3];
    const unsigned shift = 64 - log;
#define HUF_STEP(c, u, o)                                 \
  do {                                                    \
    HufE e = t[(unsigned)(((c) << (u)) >> shift)];        \
    (u) += e.nb;                                          \
    *(o)++ = e.sym;                                       \
  } while (0)
    for (int i = 0; i < k; i++) {
      HUF_STEP(c0, u0, o0);
      HUF_STEP(c1, u1, o1);
      HUF_STEP(c2, u2, o2);
      HUF_STEP(c3, u3, o3);
    }
#undef HUF_STEP
    b[0].used = u0, b[1].used = u1, b[2].used = u2, b[3].used = u3;
    op[0] = o0, op[1] = o1, op[2] = o2, op[3] = o3;
  }
  for (int s = 0; s < 4; s++) {
    while (op[s] < oend[s]) {
      bit_reload(&b[s]);
      HufE e = t[bit_peek(&b[s], log)];
      b[s].used += e.nb;
      *op[s]++ = e.sym;
    }
    bit_reload(&b[s]);
    if (bits_left(&b[s]) != 0) return ZE_CORRUPT;
  }
  return 0;
}

/* -------------------------------------------------------- sequences */

static const uint32_t LL_BASE[LL_MAX + 1] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[LL_MAX + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                                            0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                                            4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[ML_MAX + 1] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[ML_MAX + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                            0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                            5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const int16_t LL_DEFAULT[LL_MAX + 1] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                               2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[ML_MAX + 1] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

typedef struct {
  FseE t[1 << LL_LOG_MAX];
  int log; /* -1: no table yet */
} Fse;

typedef struct {
  Huf huf;
  Fse ll, of, ml;
  uint32_t rep[3];
  uint8_t lit[BLOCK_MAX + 32];
} Ctx;

/* One of the three tables by its mode; returns the bytes it took. */
static int64_t seq_table(Fse *f, int mode, const uint8_t *src, size_t n, const int16_t *dflt,
                         int dflt_max, int dflt_log, int max_sym, int log_max) {
  switch (mode) {
    case 0:
      f->log = dflt_log;
      return fse_build(f->t, dflt, dflt_max, dflt_log);
    case 1:
      if (n < 1) return ZE_TRUNCATED;
      if (src[0] > max_sym) return ZE_CORRUPT;
      f->t[0].sym = src[0];
      f->t[0].nb = 0;
      f->t[0].base = 0;
      f->log = 0;
      return 1;
    case 2: {
      int16_t norm[256];
      int ms = max_sym, log;
      int64_t k = fse_read_ncount(src, n, norm, &ms, &log, log_max);
      if (k < 0) return k;
      if (fse_build(f->t, norm, ms, log)) return ZE_CORRUPT;
      f->log = log;
      return k;
    }
    default:
      return f->log < 0 ? ZE_CORRUPT : 0;
  }
}

static inline void copy_match(uint8_t *op, size_t off, size_t len) {
  const uint8_t *m = op - off;
  if (off >= len) {
    memcpy(op, m, len);
  } else if (off >= 8) {
    while (len >= 8) { /* each 8-byte piece lies 8 or more bytes back */
      memcpy(op, m, 8);
      op += 8;
      m += 8;
      len -= 8;
    }
    while (len--) *op++ = *m++;
  } else {
    while (len--) *op++ = *m++;
  }
}

/* One compressed block into op; returns the bytes written. */
static int64_t decode_block(Ctx *x, const uint8_t *src, size_t n, uint8_t *fstart, uint8_t *op,
                            uint8_t *oend) {
  const uint8_t *ip = src, *iend = src + n;
  /* literals */
  if (n < 1) return ZE_TRUNCATED;
  int ltype = ip[0] & 3, sf = (ip[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  const uint8_t *lit;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hsize = 1;
      regen = ip[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (n < 2) return ZE_TRUNCATED;
      regen = rd16(ip) >> 4;
    } else {
      hsize = 3;
      if (n < 3) return ZE_TRUNCATED;
      regen = rd24(ip) >> 4;
    }
    if (regen > BLOCK_MAX) return ZE_CORRUPT;
    ip += hsize;
    if (ltype == 0) {
      if ((size_t)(iend - ip) < regen) return ZE_TRUNCATED;
      lit = ip;
      ip += regen;
    } else {
      if (ip >= iend) return ZE_TRUNCATED;
      memset(x->lit, *ip++, regen);
      lit = x->lit;
    }
  } else {
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      hsize = 3;
      if (n < 3) return ZE_TRUNCATED;
      uint32_t v = rd24(ip);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      hsize = 4;
      if (n < 4) return ZE_TRUNCATED;
      uint32_t v = rd32(ip);
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
    } else {
      hsize = 5;
      if (n < 5) return ZE_TRUNCATED;
      uint64_t v = rd32(ip) | (uint64_t)ip[4] << 32;
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
    if (regen > BLOCK_MAX) return ZE_CORRUPT;
    ip += hsize;
    if ((size_t)(iend - ip) < csize) return ZE_TRUNCATED;
    const uint8_t *lp = ip;
    size_t ln = csize;
    if (ltype == 2) {
      int64_t k = huf_read(&x->huf, lp, ln);
      if (k < 0) return k;
      lp += k;
      ln -= (size_t)k;
    } else if (x->huf.log == 0) {
      return ZE_CORRUPT; /* treeless literals with no earlier table */
    }
    int r = streams == 1 ? huf_stream(&x->huf, lp, ln, x->lit, x->lit + regen)
                         : huf_4streams(&x->huf, lp, ln, x->lit, regen);
    if (r) return r;
    ip += csize;
    lit = x->lit;
  }
  const uint8_t *lend = lit + regen;

  /* sequences */
  if (ip >= iend) return ZE_TRUNCATED;
  size_t nseq = *ip++;
  if (nseq >= 128) {
    if (nseq == 255) {
      if (iend - ip < 2) return ZE_TRUNCATED;
      nseq = rd16(ip) + 0x7F00;
      ip += 2;
    } else {
      if (ip >= iend) return ZE_TRUNCATED;
      nseq = ((nseq - 128) << 8) + *ip++;
    }
  }
  uint8_t *o = op;
  if (nseq) {
    if (ip >= iend) return ZE_TRUNCATED;
    int modes = *ip++;
    if (modes & 3) return ZE_RESERVED;
    int64_t k;
    k = seq_table(&x->ll, modes >> 6, ip, iend - ip, LL_DEFAULT, LL_MAX, 6, LL_MAX, LL_LOG_MAX);
    if (k < 0) return k;
    ip += k;
    k = seq_table(&x->of, (modes >> 4) & 3, ip, iend - ip, OF_DEFAULT, 28, 5, OF_MAX, OF_LOG_MAX);
    if (k < 0) return k;
    ip += k;
    k = seq_table(&x->ml, (modes >> 2) & 3, ip, iend - ip, ML_DEFAULT, ML_MAX, 6, ML_MAX,
                  ML_LOG_MAX);
    if (k < 0) return k;
    ip += k;
    BitR b;
    if (bit_init(&b, ip, iend - ip)) return ZE_CORRUPT;
    const FseE *tll = x->ll.t, *tof = x->of.t, *tml = x->ml.t;
    unsigned sll = (unsigned)bit_read(&b, x->ll.log);
    bit_reload(&b);
    unsigned sof = (unsigned)bit_read(&b, x->of.log);
    bit_reload(&b);
    unsigned sml = (unsigned)bit_read(&b, x->ml.log);
    bit_reload(&b);
    uint32_t *rep = x->rep;
    for (size_t i = 0; i < nseq; i++) {
      unsigned llc = tll[sll].sym, ofc = tof[sof].sym, mlc = tml[sml].sym;
      if (ofc > OF_MAX) return ZE_CORRUPT;
      size_t off;
      size_t ofv = ((size_t)1 << ofc) + (size_t)bit_read(&b, ofc);
      bit_reload(&b);
      size_t ml = ML_BASE[mlc] + (size_t)bit_read(&b, ML_BITS[mlc]);
      size_t ll = LL_BASE[llc] + (size_t)bit_read(&b, LL_BITS[llc]);
      bit_reload(&b);
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = (uint32_t)off;
      } else {
        size_t idx = ofv - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? (size_t)rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = (uint32_t)off;
        }
      }
      if (i + 1 < nseq) {
        sll = tll[sll].base + (unsigned)bit_read(&b, tll[sll].nb);
        sml = tml[sml].base + (unsigned)bit_read(&b, tml[sml].nb);
        bit_reload(&b);
        sof = tof[sof].base + (unsigned)bit_read(&b, tof[sof].nb);
        bit_reload(&b);
      }
      if ((size_t)(lend - lit) < ll || (size_t)(oend - o) < ll + ml) {
        return (size_t)(lend - lit) < ll ? ZE_CORRUPT : ZE_DST_TOO_SMALL;
      }
      memcpy(o, lit, ll);
      o += ll;
      lit += ll;
      if (off == 0 || off > (size_t)(o - fstart)) return ZE_CORRUPT;
      copy_match(o, off, ml);
      o += ml;
      if (bits_left(&b) < 0) return ZE_CORRUPT;
    }
    if (bits_left(&b) != 0) return ZE_CORRUPT;
  } else if (ip != iend) {
    return ZE_CORRUPT;
  }
  size_t rest = (size_t)(lend - lit);
  if ((size_t)(oend - o) < rest) return ZE_DST_TOO_SMALL;
  memcpy(o, lit, rest);
  o += rest;
  return o - op;
}

/* ----------------------------------------------------------- frames */

#define ZSTD_MAGIC 0xFD2FB528u
#define SKIP_MAGIC 0x184D2A50u

typedef struct {
  uint64_t content_size; /* UINT64_MAX: not declared */
  int checksum;
  size_t header;
} FrameHeader;

static int frame_header(const uint8_t *src, size_t n, FrameHeader *f) {
  if (n < 5) return ZE_TRUNCATED;
  int fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) return ZE_RESERVED;
  size_t dict_size = dict_flag == 3 ? 4 : (size_t)dict_flag;
  size_t fcs_size = fcs_flag == 0 ? (size_t)single : (size_t)1 << fcs_flag;
  size_t pos = 5 + !single;
  if (n < pos + dict_size + fcs_size) return ZE_TRUNCATED;
  uint32_t dict = 0;
  for (size_t i = 0; i < dict_size; i++) dict |= (uint32_t)src[pos + i] << (8 * i);
  if (dict) return ZE_DICTIONARY;
  pos += dict_size;
  uint64_t fcs = UINT64_MAX;
  if (fcs_size == 1) fcs = src[pos];
  if (fcs_size == 2) fcs = rd16(src + pos) + 256;
  if (fcs_size == 4) fcs = rd32(src + pos);
  if (fcs_size == 8) fcs = rd64(src + pos);
  f->content_size = fcs;
  f->checksum = (fhd >> 2) & 1;
  f->header = pos + fcs_size;
  return 0;
}

/* A frame's total compressed length, walking its block headers. */
static int64_t frame_length(const uint8_t *src, size_t n, const FrameHeader *f) {
  size_t pos = f->header;
  for (;;) {
    if (n - pos < 3) return ZE_TRUNCATED;
    uint32_t bh = rd24(src + pos);
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) return ZE_RESERVED;
    pos += 3 + (type == 1 ? 1 : size);
    if (pos > n) return ZE_TRUNCATED;
    if (bh & 1) break;
  }
  pos += f->checksum ? 4 : 0;
  return pos > n ? ZE_TRUNCATED : (int64_t)pos;
}

static int64_t skippable_length(const uint8_t *src, size_t n) {
  if (n < 8) return ZE_TRUNCATED;
  uint64_t len = 8 + (uint64_t)rd32(src + 4);
  return len > n ? ZE_TRUNCATED : (int64_t)len;
}

int64_t zstd_decoded_size(const uint8_t *src, size_t n) {
  int64_t total = 0;
  while (n) {
    if (n < 4) return ZE_TRUNCATED;
    uint32_t magic = rd32(src);
    int64_t len;
    if ((magic & 0xFFFFFFF0u) == SKIP_MAGIC) {
      len = skippable_length(src, n);
    } else if (magic == ZSTD_MAGIC) {
      FrameHeader f;
      int r = frame_header(src, n, &f);
      if (r) return r;
      if (f.content_size == UINT64_MAX) return ZE_UNKNOWN_SIZE;
      if (f.content_size > (uint64_t)INT64_MAX - (uint64_t)total) return ZE_CORRUPT;
      total += (int64_t)f.content_size;
      len = frame_length(src, n, &f);
    } else {
      return ZE_MAGIC;
    }
    if (len < 0) return len;
    src += len;
    n -= (size_t)len;
  }
  return total;
}

static int64_t decode_frame(Ctx *x, const uint8_t *src, size_t n, size_t *took, uint8_t *dst,
                            uint8_t *dend) {
  FrameHeader f;
  int r = frame_header(src, n, &f);
  if (r) return r;
  if (f.content_size != UINT64_MAX && f.content_size > (uint64_t)(dend - dst))
    return ZE_DST_TOO_SMALL;
  x->huf.log = 0;
  x->ll.log = x->of.log = x->ml.log = -1;
  x->rep[0] = 1;
  x->rep[1] = 4;
  x->rep[2] = 8;
  const uint8_t *ip = src + f.header, *iend = src + n;
  uint8_t *op = dst;
  for (;;) {
    if (iend - ip < 3) return ZE_TRUNCATED;
    uint32_t bh = rd24(ip);
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    ip += 3;
    if (type == 3) return ZE_RESERVED;
    if (size > BLOCK_MAX) return ZE_CORRUPT;
    if (type == 0) {
      if ((size_t)(iend - ip) < size) return ZE_TRUNCATED;
      if ((size_t)(dend - op) < size) return ZE_DST_TOO_SMALL;
      memcpy(op, ip, size);
      op += size;
      ip += size;
    } else if (type == 1) {
      if (ip >= iend) return ZE_TRUNCATED;
      if ((size_t)(dend - op) < size) return ZE_DST_TOO_SMALL;
      memset(op, *ip++, size);
      op += size;
    } else {
      if ((size_t)(iend - ip) < size) return ZE_TRUNCATED;
      int64_t k = decode_block(x, ip, size, dst, op, dend);
      if (k < 0) return k;
      op += k;
      ip += size;
    }
    if (last) break;
  }
  if (f.content_size != UINT64_MAX && f.content_size != (uint64_t)(op - dst)) return ZE_CORRUPT;
  if (f.checksum) {
    if (iend - ip < 4) return ZE_TRUNCATED;
    if ((uint32_t)xxh64(dst, op - dst) != rd32(ip)) return ZE_CHECKSUM;
    ip += 4;
  }
  *took = (size_t)(ip - src);
  return op - dst;
}

int64_t zstd_decode(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
  if (n == 0) return ZE_TRUNCATED;
  Ctx *x = (Ctx *)malloc(sizeof(Ctx));
  if (!x) return ZE_NO_MEMORY;
  uint8_t *op = dst, *dend = dst + cap;
  int64_t out = 0;
  while (n) {
    if (n < 4) {
      out = ZE_TRUNCATED;
      break;
    }
    uint32_t magic = rd32(src);
    size_t took = 0;
    if ((magic & 0xFFFFFFF0u) == SKIP_MAGIC) {
      int64_t len = skippable_length(src, n);
      if (len < 0) {
        out = len;
        break;
      }
      took = (size_t)len;
    } else if (magic == ZSTD_MAGIC) {
      int64_t k = decode_frame(x, src, n, &took, op, dend);
      if (k < 0) {
        out = k;
        break;
      }
      op += k;
    } else {
      out = ZE_MAGIC;
      break;
    }
    src += took;
    n -= took;
  }
  free(x);
  return out < 0 ? out : (int64_t)(op - dst);
}
