// Native JPEG entropy front-end.
//
// Implements the bit-serial Huffman scan loop (sequential and progressive)
// with semantics matching the reference decoder
// (/root/reference/src/jpeg/decoder.zig:909-1022 bit reader,
// :1294-1455 MCU traversal, :1459-1549 refinement, :1432-1452 restarts).
// The Python decoder calls this per SOS via ctypes; any anomaly returns a
// nonzero code and Python falls back to its own scan, so this path only
// ever handles the well-formed fast case.
//
// Output is per-component coefficient tensors in natural (un-zigzagged)
// order, ready for the batched device dequant+IDCT graph.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libzpix_entropy.so entropy.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxCodeLength = 16;

const uint8_t kUnzig[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Error codes (mirror zpix.errors usage in the Python fallback).
enum {
  OK = 0,
  ERR_EOF = 1,
  ERR_MISSING_FF00 = 2,
  ERR_BAD_HUFFMAN = 3,
  ERR_UNINIT_TABLE = 4,
  ERR_EXCESSIVE_DC = 5,
  ERR_BAD_RST = 6,
  ERR_UNEXPECTED_CODE = 7,
  ERR_TOO_MANY_COEFFS = 8,
};

struct HuffTable {
  // Layout mirrors zpix/codecs/jpeg/tables.py (HuffTable.zig),
  // plus a full 16-bit-lookahead LUT built lazily on this side
  // (entry = value << 5 | code_length; 0 = invalid) so the hot decode
  // is one table hit with no slow path except at stream tails.
  uint16_t lut[256];
  int32_t min_codes[kMaxCodeLength];
  int32_t max_codes[kMaxCodeLength];
  int32_t vals_indices[kMaxCodeLength];
  uint8_t vals[256];
  int32_t num_codes;
  int32_t lut16_ready;
  uint16_t lut16[1 << 16];
};

// Threaded callers share one HuffTable across per-image workers, so the
// lazy build must be race-free: without the mutex two threads could
// interleave memset/fill (one returns early and decodes against a
// half-zeroed table -> spurious ERR_BAD_HUFFMAN).  Acquire/release on
// lut16_ready keeps the fast path lock-free.
std::mutex g_lut16_mu;

void ensure_lut16(HuffTable* h) {
  if (__atomic_load_n(&h->lut16_ready, __ATOMIC_ACQUIRE) ||
      h->num_codes == 0)
    return;
  std::lock_guard<std::mutex> lk(g_lut16_mu);
  if (__atomic_load_n(&h->lut16_ready, __ATOMIC_ACQUIRE)) return;
  memset(h->lut16, 0, sizeof(h->lut16));
  for (int i = 0; i < kMaxCodeLength; i++) {
    if (h->max_codes[i] < 0) continue;
    int ln = i + 1, sh = 16 - ln;
    for (int32_t code = h->min_codes[i]; code <= h->max_codes[i]; code++) {
      uint16_t e = uint16_t(
          (h->vals[h->vals_indices[i] + code - h->min_codes[i]] << 5) | ln);
      uint32_t b = uint32_t(code) << sh;
      for (uint32_t k = 0; k < (1u << sh); k++) h->lut16[b + k] = e;
    }
  }
  __atomic_store_n(&h->lut16_ready, 1, __ATOMIC_RELEASE);
}

struct ScanComp {
  int32_t c_index;   // component index in frame
  int32_t dc_table;  // Td
  int32_t ac_table;  // Ta
  int32_t h, v;      // sampling factors
  int32_t bh;        // block-grid width (mxx * h): coeff row stride /64
};

// Eager 64-bit bit reader (libjpeg-turbo style refill).
//
// Differs from the reference's demand-driven one-byte-at-a-time reader
// only in *how far ahead* raw bytes are buffered; decoded symbols are
// identical.  At segment boundaries (restart markers, scan end) all whole
// unconsumed bytes are rewound via a unit-cost ring (stuffed FF00 pairs
// cost 2), which lands at-or-before the position the reference's
// unread-prologue reaches; both then converge through the marker-resync /
// extraneous-byte-skip paths, so well-formed streams produce identical
// output and the reference's corrupt-stream error matrix is preserved
// (validated by the RST corruption tests running through this path).
struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  uint64_t a;   // accumulator, top `n` bits valid at (a >> (n-k))
  int32_t n;    // buffered bit count
  int stop_err;  // 0 while refillable; ERR_MISSING_FF00/ERR_EOF at boundary
  uint8_t costs[8];  // ring: raw-byte cost of each buffered unit (1 or 2)
  uint32_t cost_idx;

  inline void refill() {
    while (n <= 48 && stop_err == OK) {
      if (pos >= len) {
        stop_err = ERR_EOF;
        return;
      }
      uint8_t x = data[pos];
      uint8_t cost = 1;
      if (x == 0xFF) {
        if (pos + 1 >= len) {
          stop_err = ERR_EOF;
          return;
        }
        if (data[pos + 1] != 0x00) {
          stop_err = ERR_MISSING_FF00;
          return;
        }
        cost = 2;
      }
      pos += cost;
      costs[cost_idx++ & 7] = cost;
      a = (a << 8) | uint64_t(x);
      n += 8;
    }
  }

  // Rewind every whole unconsumed unit; leftover sub-byte bits are
  // discarded (the reference discards them too, see decoder.zig:417-423).
  inline void rewind_to_boundary() {
    int32_t units = n >> 3;
    for (int32_t k = 0; k < units; k++) {
      cost_idx--;
      pos -= costs[cost_idx & 7];
    }
    a = 0;
    n = 0;
    stop_err = OK;
  }

  inline int decode_bit(int* out) {
    if (n == 0) {
      refill();
      if (n == 0) return stop_err;
    }
    n -= 1;
    *out = (a >> n) & 1;
    return OK;
  }

  inline int decode_bits(int32_t count, uint32_t* out) {
    if (n < count) {
      refill();
      if (n < count) return stop_err;
    }
    n -= count;
    *out = uint32_t(a >> n) & ((1u << count) - 1);
    return OK;
  }

  inline int receive_extend(int t, int32_t* out) {
    if (n < t) {
      refill();
      if (n < t) return stop_err;
    }
    n -= t;
    int32_t threshold = 1 << t;
    int32_t value = int32_t((a >> n) & uint64_t(threshold - 1));
    if (value < (threshold >> 1)) value += ((-1) << t) + 1;
    *out = value;
    return OK;
  }

  inline int decode_huffman(const HuffTable* h, int* out) {
    if (h->num_codes == 0) return ERR_UNINIT_TABLE;
    if (n < 16) refill();
    if (n >= 8) {
      // L1-resident 8-bit LUT covers the common short codes
      uint16_t v = h->lut[uint32_t(a >> (n - 8)) & 0xFF];
      if (v != 0) {
        n -= int(v & 0xFF) - 1;
        *out = v >> 8;
        return OK;
      }
      if (n >= 16) {
        // long code: one 16-bit-lookahead hit instead of bit-serial
        uint16_t e = h->lut16[uint32_t(a >> (n - 16)) & 0xFFFF];
        if (e == 0) return ERR_BAD_HUFFMAN;
        n -= int(e & 31);
        *out = int(e >> 5);
        return OK;
      }
    }
    // stream tail: bit-by-bit with exact unread/stop semantics
    return decode_huffman_slow(h, out);
  }

  int decode_huffman_slow(const HuffTable* h, int* out) {
    int32_t code = 0;
    for (int i = 0; i < kMaxCodeLength; i++) {
      if (n == 0) {
        refill();
        if (n == 0) return stop_err;
      }
      n -= 1;
      code |= (a >> n) & 1;
      if (code <= h->max_codes[i]) {
        *out = h->vals[h->vals_indices[i] + code - h->min_codes[i]];
        return OK;
      }
      code <<= 1;
    }
    return ERR_BAD_HUFFMAN;
  }

  // 2-byte marker read at a segment boundary.
  int read_full2(uint8_t* out) {
    rewind_to_boundary();
    if (pos + 2 > len) return ERR_EOF;
    out[0] = data[pos];
    out[1] = data[pos + 1];
    pos += 2;
    return OK;
  }
};

// findRst resync (decoder.zig:1671-1705).
int find_rst(BitReader& br, uint8_t expected_rst, uint8_t t0, uint8_t t1) {
  while (true) {
    int i = 0;
    if (t0 == 0xFF) {
      if (t1 == expected_rst) return OK;
      if (t1 == 0xFF) {
        i = 1;
      } else if (t1 != 0x00) {
        return ERR_BAD_RST;
      }
    } else if (t1 == 0xFF) {
      t0 = 0xFF;
      i = 1;
    }
    if (br.pos + (2 - i) > br.len) return ERR_EOF;
    if (i == 1) {
      t1 = br.data[br.pos++];
    } else {
      t0 = br.data[br.pos];
      t1 = br.data[br.pos + 1];
      br.pos += 2;
    }
  }
}

struct RefineState {
  uint16_t eob_run;
};

// Successive-approximation AC refinement (decoder.zig:1459-1549).
int refine_non_zeroes(BitReader& br, int32_t* b, int32_t* zig_io,
                      int32_t zig_end, int32_t nz, int32_t delta) {
  int32_t zig = *zig_io;
  while (zig <= zig_end) {
    int u = kUnzig[zig];
    if (b[u] == 0) {
      if (nz == 0) break;
      nz--;
    } else {
      int bit;
      int rc = br.decode_bit(&bit);
      if (rc != OK) return rc;
      if (bit) {
        if (b[u] >= 0)
          b[u] += delta;
        else
          b[u] -= delta;
      }
    }
    zig++;
  }
  *zig_io = zig;
  return OK;
}

int refine_block(BitReader& br, RefineState& rs, const HuffTable* h,
                 int32_t* b, int32_t zig_start, int32_t zig_end,
                 int32_t delta) {
  if (zig_start == 0) {
    int bit;
    int rc = br.decode_bit(&bit);
    if (rc != OK) return rc;
    if (bit) b[0] |= delta;
    return OK;
  }
  int32_t zig = zig_start;
  if (rs.eob_run == 0) {
    while (zig <= zig_end) {
      int32_t z = 0;
      int value;
      int rc = br.decode_huffman(h, &value);
      if (rc != OK) return rc;
      int val0 = value >> 4;
      int val1 = value & 0x0F;
      if (val1 == 0) {
        if (val0 != 0x0F) {
          rs.eob_run = uint16_t(1u << val0);
          if (val0 != 0) {
            uint32_t bits;
            rc = br.decode_bits(val0, &bits);
            if (rc != OK) return rc;
            rs.eob_run |= uint16_t(bits);
          }
          break;
        }
      } else if (val1 == 1) {
        z = delta;
        int bit;
        rc = br.decode_bit(&bit);
        if (rc != OK) return rc;
        if (!bit) z = -z;
      } else {
        return ERR_UNEXPECTED_CODE;
      }
      rc = refine_non_zeroes(br, b, &zig, zig_end, val0, delta);
      if (rc != OK) return rc;
      if (zig > zig_end) return ERR_TOO_MANY_COEFFS;
      if (z != 0) b[kUnzig[zig]] = z;
      zig++;
    }
  }
  if (rs.eob_run > 0) {
    rs.eob_run--;
    int rc = refine_non_zeroes(br, b, &zig, zig_end, -1, delta);
    if (rc != OK) return rc;
  }
  return OK;
}

}  // namespace

extern "C" {

// Decode one scan (sequential or progressive) starting at data[pos].
//
// coeff_out[k]: int32 [bv, bh, 64] tensor for scan component k's frame
// component (natural coefficient order), already holding prior-scan state
// for progressive streams.  dc_io: int32[4] DC predictors (zeroed by
// caller).  eob_run_io: persists across scans within a decoder.
//
// Returns OK and writes the final stream state (pos/bits) back so the
// Python marker loop resumes exactly where the reference would.
int zpix_decode_scan(
    const uint8_t* data, int64_t len, int64_t pos_in,
    const HuffTable* huff,  // [2][4]: dc tables 0..3 then ac tables 4..7
    const ScanComp* scan, int32_t n_comp,
    int32_t mxx, int32_t myy, int32_t width, int32_t height,
    int32_t restart_interval,
    int32_t zig_start, int32_t zig_end, int32_t ah, int32_t al,
    int32_t progressive,
    int32_t** coeff_out,
    uint16_t* eob_run_io,
    int64_t* pos_out, int32_t* bits_n_out, int32_t* num_unreadable_out) {
  BitReader br{data, len, pos_in, 0, 0, OK, {0}, 0};
  RefineState rs{*eob_run_io};

  // the caller-marshalled tables carry only the canonical fields;
  // build the 16-bit decode LUTs in place (idempotent, ~64K writes)
  for (int32_t k = 0; k < n_comp; k++) {
    ensure_lut16(const_cast<HuffTable*>(&huff[scan[k].dc_table]));
    ensure_lut16(const_cast<HuffTable*>(&huff[4 + scan[k].ac_table]));
  }

  int32_t dc[4] = {0, 0, 0, 0};
  int32_t block_count = 0;
  uint8_t expected_rst = 0xD0;
  int64_t mcu = 0;

  for (int32_t my = 0; my < myy; my++) {
    for (int32_t mx = 0; mx < mxx; mx++) {
      for (int32_t k = 0; k < n_comp; k++) {
        const ScanComp& sc = scan[k];
        int32_t hi = sc.h, vi = sc.v;
        const HuffTable* dc_tab = &huff[sc.dc_table];
        const HuffTable* ac_tab = &huff[4 + sc.ac_table];
        for (int32_t j = 0; j < hi * vi; j++) {
          int32_t bx, by;
          if (n_comp != 1) {
            bx = hi * mx + (j % hi);
            by = vi * my + (j / hi);
          } else {
            bx = block_count % (mxx * hi);
            by = block_count / (mxx * hi);
            block_count++;
            if (bx * 8 >= width || by * 8 >= height) continue;
          }
          int32_t* b = coeff_out[k] + (int64_t(by) * sc.bh + bx) * 64;

          if (ah != 0) {
            int rc = refine_block(br, rs, ac_tab, b, zig_start, zig_end,
                                  1 << al);
            if (rc != OK) return rc;
          } else {
            int32_t zig = zig_start;
            if (zig == 0) {
              zig++;
              int value;
              int rc = br.decode_huffman(dc_tab, &value);
              if (rc != OK) return rc;
              if (value > 16) return ERR_EXCESSIVE_DC;
              int32_t dc_delta;
              rc = br.receive_extend(value, &dc_delta);
              if (rc != OK) return rc;
              dc[sc.c_index] += dc_delta;
              b[0] = dc[sc.c_index] << al;
            }
            if (zig <= zig_end && rs.eob_run > 0) {
              rs.eob_run--;
            } else {
              while (zig <= zig_end) {
                int value;
                int rc = br.decode_huffman(ac_tab, &value);
                if (rc != OK) return rc;
                int val0 = value >> 4;
                int val1 = value & 0x0F;
                if (val1 != 0) {
                  zig += val0;
                  if (zig > zig_end) break;
                  int32_t ac;
                  rc = br.receive_extend(val1, &ac);
                  if (rc != OK) return rc;
                  b[kUnzig[zig]] = ac << al;
                } else {
                  if (val0 != 0x0F) {
                    rs.eob_run = uint16_t(1u << val0);
                    if (val0 != 0) {
                      uint32_t bits;
                      rc = br.decode_bits(val0, &bits);
                      if (rc != OK) return rc;
                      rs.eob_run |= uint16_t(bits);
                    }
                    rs.eob_run--;
                    break;
                  }
                  zig += 0x0F;
                }
                zig++;
              }
            }
          }
        }
      }

      mcu++;
      if (restart_interval > 0 && mcu % restart_interval == 0 &&
          mcu < int64_t(mxx) * myy) {
        uint8_t tmp2[2];
        int rc = br.read_full2(tmp2);
        if (rc != OK) return rc;
        if (tmp2[0] != 0xFF || tmp2[1] != expected_rst) {
          rc = find_rst(br, expected_rst, tmp2[0], tmp2[1]);
          if (rc != OK) return rc;
        }
        expected_rst++;
        if (expected_rst == 0xD8) expected_rst = 0xD0;
        br.a = 0;
        br.n = 0;
        br.stop_err = OK;
        dc[0] = dc[1] = dc[2] = dc[3] = 0;
        rs.eob_run = 0;
      }
    }
  }

  *eob_run_io = rs.eob_run;
  br.rewind_to_boundary();
  *pos_out = br.pos;
  *bits_n_out = 0;
  *num_unreadable_out = 0;
  return OK;
}

// Sparse-pack a coefficient tensor for the host->device transfer.
//
// JPEG coefficient tensors are ~95% zero after quantization; to cut
// host->device bytes, blocks travel as a
// 64-bit nonzero bitmap (8 bytes, MSB-first per byte to match
// numpy.packbits) plus the nonzero values as int16.  Unpacked on-device
// inside the jit graph (zpix/parallel/batch.py).
//
// Returns the number of nonzero values written (<= cap), or -1 if cap was
// too small.
namespace {

// MSB-first bit order within each bitmap byte matches numpy.packbits.
inline uint8_t bitrev8(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  b = uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
  return b;
}

}  // namespace

#if defined(__AVX512F__) && defined(__AVX512VBMI2__)
#include <immintrin.h>
#endif

int64_t zpix_pack_sparse(const int32_t* coeff, int64_t nblocks,
                         uint8_t* bitmap_out, int16_t* vals_out,
                         int64_t cap) {
  int64_t n = 0;
#if defined(__AVX512F__) && defined(__AVX512VBMI2__)
  // 16 coefficients per iteration: compare -> mask -> narrow ->
  // vpcompressw compressed store.  64 + popcount bookkeeping per block.
  for (int64_t b = 0; b < nblocks; b++) {
    if (n + 64 > cap) return -1;
    const int32_t* blk = coeff + b * 64;
    uint8_t* bm = bitmap_out + b * 8;
    for (int q = 0; q < 4; q++) {
      __m512i v = _mm512_loadu_si512(blk + q * 16);
      __mmask16 nz = _mm512_test_epi32_mask(v, v);
      __m256i w = _mm512_cvtepi32_epi16(v);
      _mm256_mask_compressstoreu_epi16(vals_out + n, nz, w);
      n += __builtin_popcount(nz);
      bm[q * 2] = bitrev8(uint8_t(nz & 0xFF));
      bm[q * 2 + 1] = bitrev8(uint8_t(nz >> 8));
    }
  }
  return n;
#else
  for (int64_t b = 0; b < nblocks; b++) {
    if (n + 64 > cap) return -1;
    const int32_t* blk = coeff + b * 64;
    uint8_t* bm = bitmap_out + b * 8;
    for (int byte = 0; byte < 8; byte++) {
      uint8_t m = 0;
      for (int bit = 0; bit < 8; bit++) {
        int32_t v = blk[byte * 8 + bit];
        int nz = v != 0;
        m |= uint8_t(nz << (7 - bit));
        vals_out[n] = int16_t(v);
        n += nz;
      }
      bm[byte] = m;
    }
  }
  return n;
#endif
}

namespace {

// ---------------------------------------------------------------------
// Full-file baseline front-end: marker loop + DHT build + scan + pack.
// Strict fast path: anything unusual (progressive, 4-component, RGB,
// 12-bit, arithmetic coding...) returns UNSUPPORTED and the Python
// decoder handles it with identical semantics.
// ---------------------------------------------------------------------

enum {
  ERR_UNSUPPORTED = 100,
  ERR_FORMAT = 101,
};

const uint8_t kZigToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Build a HuffTable from DHT payload (decoder.zig:1070-1109).
int build_huff(HuffTable* h, const uint8_t* counts, const uint8_t* vals,
               int total) {
  if (total == 0 || total > 256) return ERR_FORMAT;
  h->num_codes = total;
  memset(h->lut, 0, sizeof(h->lut));
  memcpy(h->vals, vals, total);
  uint32_t code = 0;
  int val_index = 0;
  for (int i = 0; i < 8; i++) {
    code <<= 1;
    for (int j = 0; j < counts[i]; j++) {
      uint32_t base = code << (7 - i);
      uint16_t lut_value = uint16_t(h->vals[val_index] << 8) | uint16_t(2 + i);
      for (uint32_t k = 0; k < (1u << (7 - i)); k++) h->lut[base | k] = lut_value;
      code++;
      val_index++;
    }
  }
  int32_t code_base = 0;
  int32_t index = 0;
  for (int i = 0; i < kMaxCodeLength; i++) {
    if (counts[i] == 0) {
      h->min_codes[i] = -1;
      h->max_codes[i] = -1;
      h->vals_indices[i] = -1;
    } else {
      h->min_codes[i] = code_base;
      h->max_codes[i] = code_base + counts[i] - 1;
      h->vals_indices[i] = index;
      code_base += counts[i];
      index += counts[i];
    }
    code_base <<= 1;
  }
  h->lut16_ready = 0;
  ensure_lut16(h);
  return OK;
}

// Pack one 64-coefficient block: bitmap row + appended values.
inline int64_t pack_block(const int32_t* blk, uint8_t* bm, int16_t* tail) {
  int64_t n = 0;
#if defined(__AVX512F__) && defined(__AVX512VBMI2__)
  for (int q = 0; q < 4; q++) {
    __m512i v = _mm512_loadu_si512(blk + q * 16);
    __mmask16 nz = _mm512_test_epi32_mask(v, v);
    __m256i w = _mm512_cvtepi32_epi16(v);
    _mm256_mask_compressstoreu_epi16(tail + n, nz, w);
    n += __builtin_popcount(nz);
    bm[q * 2] = bitrev8(uint8_t(nz & 0xFF));
    bm[q * 2 + 1] = bitrev8(uint8_t(nz >> 8));
  }
#else
  for (int byte = 0; byte < 8; byte++) {
    uint8_t m = 0;
    for (int bit = 0; bit < 8; bit++) {
      int32_t v = blk[byte * 8 + bit];
      int nz = v != 0;
      m |= uint8_t(nz << (7 - bit));
      tail[n] = int16_t(v);
      n += nz;
    }
    bm[byte] = m;
  }
#endif
  return n;
}

// Sequential scan fused with sparse packing: blocks decode into an
// L1-resident buffer and emit straight to bitmap+values in *stream order*
// (the consumer applies a static stream->grid permutation on device),
// never materializing the dense coefficient tensor.
// `mcu_begin`/`mcu_end` select an MCU range (a restart segment when
// segment-parallel; the full image otherwise).  `handle_restarts` is off
// for segment workers — each segment is its own entropy-coded interval
// with fresh DC predictors (decoder.zig:1446-1451).
int decode_scan_packed(const uint8_t* data, int64_t len, int64_t pos_in,
                       const HuffTable* huff, const ScanComp* scan,
                       int32_t n_scan, int32_t mxx, int32_t myy,
                       int32_t width, int32_t height,
                       int32_t restart_interval, uint8_t** bitmaps,
                       int16_t** vals, const int64_t* caps, int64_t* nnz_io,
                       int64_t* pos_out, int64_t mcu_begin, int64_t mcu_end,
                       bool handle_restarts) {
  BitReader br{data, len, pos_in, 0, 0, OK, {0}, 0};
  int32_t dc[4] = {0, 0, 0, 0};
  uint16_t eob_run = 0;
  int64_t stream_idx[4];
  int32_t block_count;
  {
    block_count = int32_t(mcu_begin * scan[0].h * scan[0].v);
    for (int32_t k = 0; k < n_scan; k++)
      stream_idx[k] = mcu_begin * scan[k].h * scan[k].v;
  }
  uint8_t expected_rst =
      0xD0 +
      uint8_t((mcu_begin / (restart_interval > 0 ? restart_interval : 1)) & 7);
  int64_t mcu = mcu_begin;
  alignas(64) int32_t blk[64];

  for (; mcu < mcu_end;) {
    {
      for (int32_t k = 0; k < n_scan; k++) {
        const ScanComp& sc = scan[k];
        const HuffTable* dc_tab = &huff[sc.dc_table];
        const HuffTable* ac_tab = &huff[4 + sc.ac_table];
        for (int32_t j = 0; j < sc.h * sc.v; j++) {
          if (n_scan == 1) {
            int32_t bx = block_count % (mxx * sc.h);
            int32_t by = block_count / (mxx * sc.h);
            block_count++;
            if (bx * 8 >= width || by * 8 >= height) {
              // Out-of-image block: no stream data, but it owns a stream
              // slot so stream order == grid order when non-interleaved.
              memset(bitmaps[k] + stream_idx[k] * 8, 0, 8);
              stream_idx[k]++;
              continue;
            }
          }
          if (nnz_io[k] + 64 > caps[k]) return ERR_FORMAT;
          memset(blk, 0, sizeof(blk));

          // DC (decoder.zig:1366-1376).
          int value;
          int rc = br.decode_huffman(dc_tab, &value);
          if (rc != OK) return rc;
          if (value > 16) return ERR_EXCESSIVE_DC;
          int32_t dc_delta;
          rc = br.receive_extend(value, &dc_delta);
          if (rc != OK) return rc;
          dc[sc.c_index] += dc_delta;
          blk[0] = dc[sc.c_index];

          // AC (decoder.zig:1379-1411), zig range 1..63, al == 0.
          if (eob_run > 0) {
            eob_run--;
          } else {
            int32_t zig = 1;
            while (zig <= 63) {
              rc = br.decode_huffman(ac_tab, &value);
              if (rc != OK) return rc;
              int val0 = value >> 4;
              int val1 = value & 0x0F;
              if (val1 != 0) {
                zig += val0;
                if (zig > 63) break;
                int32_t ac;
                rc = br.receive_extend(val1, &ac);
                if (rc != OK) return rc;
                blk[kUnzig[zig]] = ac;
              } else {
                if (val0 != 0x0F) {
                  eob_run = uint16_t(1u << val0);
                  if (val0 != 0) {
                    uint32_t bits;
                    rc = br.decode_bits(val0, &bits);
                    if (rc != OK) return rc;
                    eob_run |= uint16_t(bits);
                  }
                  eob_run--;
                  break;
                }
                zig += 0x0F;
              }
              zig++;
            }
          }

          nnz_io[k] += pack_block(blk, bitmaps[k] + stream_idx[k] * 8,
                                  vals[k] + nnz_io[k]);
          stream_idx[k]++;
        }
      }

      mcu++;
      if (handle_restarts && restart_interval > 0 &&
          mcu % restart_interval == 0 && mcu < int64_t(mxx) * myy) {
        uint8_t tmp2[2];
        int rc = br.read_full2(tmp2);
        if (rc != OK) return rc;
        if (tmp2[0] != 0xFF || tmp2[1] != expected_rst) {
          rc = find_rst(br, expected_rst, tmp2[0], tmp2[1]);
          if (rc != OK) return rc;
        }
        expected_rst++;
        if (expected_rst == 0xD8) expected_rst = 0xD0;
        br.a = 0;
        br.n = 0;
        br.stop_err = OK;
        dc[0] = dc[1] = dc[2] = dc[3] = 0;
        eob_run = 0;
      }
    }
  }

  br.rewind_to_boundary();
  *pos_out = br.pos;
  return OK;
}

// Segment-parallel wrapper: when the stream carries restart markers, each
// restart interval is an independent entropy segment (fresh bit state, DC
// predictors, EOB run — decoder.zig:1432-1452), so segments decode on a
// thread pool and values compact back to stream order afterwards.  This
// is the intra-image sequence-parallel axis (SURVEY.md sec.2.7): the same
// split that shards MCU-row stripes across devices shards segments across
// host cores.  Returns ERR_UNSUPPORTED when markers are missing/misplaced
// (caller falls back to the serial exact path).
int decode_scan_packed_mt(const uint8_t* data, int64_t len, int64_t pos_in,
                          const HuffTable* huff, const ScanComp* scan,
                          int32_t n_scan, int32_t mxx, int32_t myy,
                          int32_t width, int32_t height,
                          int32_t restart_interval, uint8_t** bitmaps,
                          int16_t** vals, const int64_t* caps,
                          int64_t* nnz_io, int64_t* pos_out,
                          int32_t n_threads) {
  int64_t total_mcus = int64_t(mxx) * myy;
  if (restart_interval <= 0 || n_threads <= 1 ||
      total_mcus <= restart_interval) {
    return decode_scan_packed(data, len, pos_in, huff, scan, n_scan, mxx,
                              myy, width, height, restart_interval, bitmaps,
                              vals, caps, nnz_io, pos_out, 0, total_mcus,
                              true);
  }

  // Locate segment starts: RSTn markers cannot appear inside entropy data
  // (0xFF is always stuffed as FF00), so a byte scan finds exact splits.
  int64_t n_segs = (total_mcus + restart_interval - 1) / restart_interval;
  std::vector<int64_t> seg_start(n_segs);
  seg_start[0] = pos_in;
  {
    int64_t s = 1;
    uint8_t expect = 0xD0;
    for (int64_t p = pos_in; p + 1 < len && s < n_segs; p++) {
      if (data[p] == 0xFF) {
        uint8_t m = data[p + 1];
        if (m >= 0xD0 && m <= 0xD7) {
          if (m != expect) return ERR_UNSUPPORTED;  // misordered: serial path
          seg_start[s++] = p + 2;
          expect = (expect == 0xD7) ? 0xD0 : expect + 1;
          p++;
        } else if (m != 0x00) {
          break;  // non-RST marker: end of scan data
        }
      }
    }
    if (s != n_segs) return ERR_UNSUPPORTED;
  }

  // Per-segment scratch for values (unknown per-segment nnz); bitmaps
  // write directly at their stream offsets.
  std::vector<std::vector<int16_t>> seg_vals(n_segs);
  std::vector<std::vector<int64_t>> seg_nnz(n_segs);
  std::vector<int> seg_rc(n_segs, OK);
  std::vector<int64_t> seg_pos(n_segs, 0);
  std::atomic<int64_t> next{0};

  auto worker = [&]() {
    while (true) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs) return;
      int64_t mb = s * restart_interval;
      int64_t me = std::min(total_mcus, mb + restart_interval);
      int64_t blocks = 0;
      for (int32_t k = 0; k < n_scan; k++)
        blocks += (me - mb) * scan[k].h * scan[k].v;
      seg_vals[s].resize(blocks * 64);
      seg_nnz[s].assign(4, 0);
      int16_t* sv[4];
      int64_t sc_caps[4];
      int64_t scratch_off = 0;
      for (int32_t k = 0; k < n_scan; k++) {
        int64_t cap_k = (me - mb) * scan[k].h * scan[k].v * 64;
        sv[k] = seg_vals[s].data() + scratch_off;
        sc_caps[k] = cap_k;
        scratch_off += cap_k;
      }
      seg_rc[s] = decode_scan_packed(
          data, len, seg_start[s], huff, scan, n_scan, mxx, myy, width,
          height, restart_interval, bitmaps, sv, sc_caps,
          seg_nnz[s].data(), &seg_pos[s], mb, me, false);
      // Rebase: sv[k] points at scratch, but decode_scan_packed indexed
      // vals[k] + nnz (starting at 0) so values are already contiguous
      // per component within the scratch.
    }
  };
  {
    std::vector<std::thread> threads;
    int nt = int(std::min<int64_t>(n_threads, n_segs));
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  for (int64_t s = 0; s < n_segs; s++)
    if (seg_rc[s] != OK) return seg_rc[s];

  // Compact per-segment values into the global stream-order arrays.
  for (int32_t k = 0; k < n_scan; k++) nnz_io[k] = 0;
  for (int64_t s = 0; s < n_segs; s++) {
    int64_t mb = s * restart_interval;
    int64_t me = std::min(total_mcus, mb + restart_interval);
    int64_t scratch_off = 0;
    for (int32_t k = 0; k < n_scan; k++) {
      int64_t cap_k = (me - mb) * scan[k].h * scan[k].v * 64;
      int64_t cnt = seg_nnz[s][k];
      if (nnz_io[k] + cnt > caps[k]) return ERR_FORMAT;
      memcpy(vals[k] + nnz_io[k], seg_vals[s].data() + scratch_off,
             cnt * sizeof(int16_t));
      nnz_io[k] += cnt;
      scratch_off += cap_k;
    }
  }
  *pos_out = seg_pos[n_segs - 1];  // resume the marker loop after the
  return OK;                        // final segment's entropy data
}

}  // namespace

extern "C" int zpix_decode_scan(
    const uint8_t*, int64_t, int64_t, const HuffTable*, const ScanComp*,
    int32_t, int32_t, int32_t, int32_t, int32_t, int32_t, int32_t, int32_t,
    int32_t, int32_t, int32_t, int32_t**, uint16_t*, int64_t*, int32_t*,
    int32_t*);

extern "C" int64_t zpix_pack_sparse(const int32_t*, int64_t, uint8_t*,
                                    int16_t*, int64_t);

// Parse a whole baseline JPEG and emit sparse-packed coefficients.
//
// Caller pre-sizes the output buffers from a cheap SOF peek:
//   bitmaps[c]: uint8[bv*bh*8], vals[c]: int16[vals_cap[c]]
// quant_nat: int32[3][64] natural order per component; nnz_out: int64[3].
// Returns OK, ERR_UNSUPPORTED (Python fallback required) or an error code.
extern "C" int zpix_parse_baseline(
    const uint8_t* data, int64_t len,
    int32_t expect_width, int32_t expect_height,
    uint8_t** bitmaps, int16_t** vals, const int64_t* vals_cap,
    int32_t* quant_nat, int64_t* nnz_out, int32_t n_threads) {
  int64_t pos = 0;
  if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) return ERR_FORMAT;
  pos = 2;

  HuffTable huff[8];
  for (auto& h : huff) h.num_codes = 0;
  int32_t quant_zig[4][64];
  bool quant_set[4] = {false, false, false, false};

  int32_t width = 0, height = 0, ncomp = 0;
  int32_t comp_h[4] = {0}, comp_v[4] = {0};
  uint8_t comp_id[4] = {0}, comp_tq[4] = {0};
  int32_t restart_interval = 0;
  bool jfif = false, adobe_valid = false;
  int adobe_transform = 0;
  bool seen_sos = false;
  int32_t mxx = 0, myy = 0;
  int rc_out = OK;

  auto cleanup = [&]() {};

  while (true) {
    if (pos + 2 > len) {
      cleanup();
      return ERR_EOF;
    }
    uint8_t t0 = data[pos], t1 = data[pos + 1];
    pos += 2;
    while (t0 != 0xFF) {
      // Liberal extraneous-byte skip (decoder.zig:246-269).
      t0 = t1;
      if (pos >= len) {
        cleanup();
        return ERR_EOF;
      }
      t1 = data[pos++];
    }
    uint8_t marker = t1;
    if (marker == 0) continue;
    while (marker == 0xFF) {
      if (pos >= len) {
        cleanup();
        return ERR_EOF;
      }
      marker = data[pos++];
    }
    if (marker == 0xD9) break;  // EOI
    if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RST

    if (pos + 2 > len) {
      cleanup();
      return ERR_EOF;
    }
    int32_t n = ((int32_t(data[pos]) << 8) | data[pos + 1]) - 2;
    pos += 2;
    if (n < 0 || pos + n > len) {
      cleanup();
      return ERR_FORMAT;
    }
    const uint8_t* seg = data + pos;

    switch (marker) {
      case 0xC0:
      case 0xC1: {  // SOF0/1: baseline / extended sequential
        if (ncomp != 0 || n < 6) {
          cleanup();
          return ERR_FORMAT;
        }
        if (seg[0] != 8) {
          cleanup();
          return ERR_UNSUPPORTED;
        }
        height = (seg[1] << 8) | seg[2];
        width = (seg[3] << 8) | seg[4];
        ncomp = seg[5];
        if (ncomp != 1 && ncomp != 3) {
          cleanup();
          return ERR_UNSUPPORTED;
        }
        if (n != 6 + 3 * ncomp) {
          cleanup();
          return ERR_FORMAT;
        }
        if (width != expect_width || height != expect_height) {
          cleanup();
          return ERR_FORMAT;
        }
        for (int i = 0; i < ncomp; i++) {
          comp_id[i] = seg[6 + 3 * i];
          uint8_t hv = seg[7 + 3 * i];
          int h = hv >> 4, v = hv & 0x0F;
          if (h < 1 || h > 4 || v < 1 || v > 4 || h == 3 || v == 3) {
            cleanup();
            return ERR_UNSUPPORTED;
          }
          if (ncomp == 1) {
            h = 1;
            v = 1;
          }
          comp_h[i] = h;
          comp_v[i] = v;
          comp_tq[i] = seg[8 + 3 * i];
          if (comp_tq[i] > 3) {
            cleanup();
            return ERR_FORMAT;
          }
        }
        if (ncomp == 3) {
          if (comp_v[0] == 4) {
            cleanup();
            return ERR_UNSUPPORTED;
          }
          if (comp_h[0] % comp_h[1] != 0 || comp_v[0] % comp_v[1] != 0 ||
              comp_h[1] != comp_h[2] || comp_v[1] != comp_v[2]) {
            cleanup();
            return ERR_UNSUPPORTED;
          }
        }
        mxx = (width + 8 * comp_h[0] - 1) / (8 * comp_h[0]);
        myy = (height + 8 * comp_v[0] - 1) / (8 * comp_v[0]);
        break;
      }
      case 0xC2:  // progressive: Python path
        cleanup();
        return ERR_UNSUPPORTED;
      case 0xC4: {  // DHT
        int32_t rem = n;
        const uint8_t* p = seg;
        while (rem > 0) {
          if (rem < 17) {
            cleanup();
            return ERR_FORMAT;
          }
          int tc = p[0] >> 4, th = p[0] & 0x0F;
          if (tc > 1 || th > 3) {
            cleanup();
            return ERR_FORMAT;
          }
          int total = 0;
          for (int i = 1; i <= 16; i++) total += p[i];
          if (rem < 17 + total) {
            cleanup();
            return ERR_FORMAT;
          }
          int rc = build_huff(&huff[tc * 4 + th], p + 1, p + 17, total);
          if (rc != OK) {
            cleanup();
            return rc;
          }
          p += 17 + total;
          rem -= 17 + total;
        }
        break;
      }
      case 0xDB: {  // DQT
        int32_t rem = n;
        const uint8_t* p = seg;
        while (rem > 0) {
          int tq = p[0] & 0x0F, pq = p[0] >> 4;
          if (tq > 3) {
            cleanup();
            return ERR_FORMAT;
          }
          if (pq == 0) {
            if (rem < 65) {
              cleanup();
              return ERR_FORMAT;
            }
            for (int i = 0; i < 64; i++) quant_zig[tq][i] = p[1 + i];
            p += 65;
            rem -= 65;
          } else if (pq == 1) {
            if (rem < 129) {
              cleanup();
              return ERR_FORMAT;
            }
            for (int i = 0; i < 64; i++)
              quant_zig[tq][i] = (int32_t(p[1 + 2 * i]) << 8) | p[2 + 2 * i];
            p += 129;
            rem -= 129;
          } else {
            cleanup();
            return ERR_FORMAT;
          }
          quant_set[tq] = true;
        }
        break;
      }
      case 0xDD:  // DRI
        if (n != 2) {
          cleanup();
          return ERR_FORMAT;
        }
        restart_interval = (int32_t(seg[0]) << 8) | seg[1];
        break;
      case 0xE0:  // APP0
        if (n >= 5) jfif = memcmp(seg, "JFIF\x00", 5) == 0;
        break;
      case 0xEE:  // APP14
        if (n >= 12 && memcmp(seg, "Adobe", 5) == 0) {
          adobe_valid = true;
          adobe_transform = seg[11];
        }
        break;
      case 0xDA: {  // SOS
        if (ncomp == 0) {
          cleanup();
          return ERR_FORMAT;
        }
        // RGB JPEGs need the Python convertToRGB path.
        bool is_rgb = !jfif && ((adobe_valid && adobe_transform == 0) ||
                                (ncomp == 3 && comp_id[0] == 'R' &&
                                 comp_id[1] == 'G' && comp_id[2] == 'B'));
        if (is_rgb) {
          cleanup();
          return ERR_UNSUPPORTED;
        }
        int n_scan = seg[0];
        if (n != 4 + 2 * n_scan || n_scan < 1 || n_scan > ncomp) {
          cleanup();
          return ERR_FORMAT;
        }
        if (seen_sos || n_scan != ncomp) {
          // Multi-scan sequential streams take the Python path.
          cleanup();
          return ERR_UNSUPPORTED;
        }
        seen_sos = true;
        ScanComp sc[4];
        uint8_t* scan_bm[4];
        int16_t* scan_vals[4];
        int64_t scan_caps[4];
        int64_t scan_nnz[4] = {0, 0, 0, 0};
        for (int i = 0; i < n_scan; i++) {
          int ci = -1;
          for (int j = 0; j < ncomp; j++)
            if (seg[1 + 2 * i] == comp_id[j]) ci = j;
          if (ci < 0) {
            cleanup();
            return ERR_FORMAT;
          }
          sc[i].c_index = ci;
          sc[i].dc_table = seg[2 + 2 * i] >> 4;
          sc[i].ac_table = seg[2 + 2 * i] & 0x0F;
          if (sc[i].dc_table > 3 || sc[i].ac_table > 3) {
            cleanup();
            return ERR_FORMAT;
          }
          sc[i].h = comp_h[ci];
          sc[i].v = comp_v[ci];
          sc[i].bh = mxx * comp_h[ci];
          scan_bm[i] = bitmaps[ci];
          scan_vals[i] = vals[ci];
          scan_caps[i] = vals_cap[ci];
        }
        int64_t pos_out;
        pos += n;  // scan header consumed
        int rc = decode_scan_packed_mt(
            data, len, pos, huff, sc, n_scan, mxx, myy, width, height,
            restart_interval, scan_bm, scan_vals, scan_caps, scan_nnz,
            &pos_out, n_threads);
        if (rc == ERR_UNSUPPORTED && n_threads > 1)
          rc = decode_scan_packed(
              data, len, pos, huff, sc, n_scan, mxx, myy, width, height,
              restart_interval, scan_bm, scan_vals, scan_caps, scan_nnz,
              &pos_out, 0, int64_t(mxx) * myy, true);
        if (rc != OK) {
          cleanup();
          return rc;
        }
        for (int i = 0; i < n_scan; i++) nnz_out[sc[i].c_index] = scan_nnz[i];
        pos = pos_out;
        continue;  // pos already advanced
      }
      default:
        if ((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE) {
          break;  // skip APPn/COM
        }
        cleanup();
        return marker < 0xC0 ? ERR_FORMAT : ERR_UNSUPPORTED;
    }
    pos += n;
  }

  if (!seen_sos) {
    cleanup();
    return ERR_FORMAT;
  }

  for (int i = 0; i < ncomp; i++) {
    if (!quant_set[comp_tq[i]]) {
      cleanup();
      return ERR_FORMAT;
    }
    for (int z = 0; z < 64; z++)
      quant_nat[i * 64 + kZigToNat[z]] = quant_zig[comp_tq[i]][z];
  }
  cleanup();
  return rc_out;
}

// Batched front-end: parse N baseline JPEGs with an internal thread pool.
//
// All images must share the geometry implied by the caller's buffers
// (validated per image via expect_width/height).  Layout per component c:
//   bitmaps_c: uint8 [n_images, nb_c * 8]   (row i = image i)
//   vals_c:    int16 [n_images, vals_cap_c]
//   quants_c:  int32 [n_images, 64] — written per image (natural order)
//   nnz_out:   int64 [n_images, 3]
// rc_out: int32[n_images] per-image return codes.
extern "C" int zpix_parse_baseline_batch(
    const uint8_t** datas, const int64_t* lens, int32_t n_images,
    int32_t expect_width, int32_t expect_height, int32_t ncomp,
    uint8_t** bitmaps, int16_t** vals, const int64_t* vals_cap,
    const int64_t* bitmap_stride,  // per comp: nb_c * 8
    int32_t** quants, int64_t* nnz_out, int32_t* rc_out, int32_t n_threads) {
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n_images) return;
      uint8_t* bm[4];
      int16_t* vl[4];
      int64_t cap[4];
      int32_t quant_nat[3 * 64];
      int64_t nnz[4] = {0, 0, 0, 0};
      for (int c = 0; c < ncomp; c++) {
        bm[c] = bitmaps[c] + int64_t(i) * bitmap_stride[c];
        vl[c] = vals[c] + int64_t(i) * vals_cap[c];
        cap[c] = vals_cap[c];
      }
      int rc = zpix_parse_baseline(datas[i], lens[i], expect_width,
                                   expect_height, bm, vl, cap, quant_nat,
                                   nnz, 1);
      rc_out[i] = rc;
      if (rc == OK) {
        for (int c = 0; c < ncomp; c++) {
          memcpy(quants[c] + int64_t(i) * 64, quant_nat + c * 64,
                 64 * sizeof(int32_t));
          nnz_out[int64_t(i) * 3 + c] = nnz[c];
        }
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  for (int32_t i = 0; i < n_images; i++)
    if (rc_out[i] != OK) return rc_out[i];
  return OK;
}

// ---------------------------------------------------------------------
// Progressive AC-refinement INDEX pass (the round-4 host/device split).
//
// AC refinement bit consumption is gated on each block's accumulated
// nonzero pattern, so speculative chunk lanes cannot self-synchronize
// (progressive_onchip.py design note).  This pass walks one DESTUFFED
// refinement scan maintaining ONLY the per-block zigzag nonzero masks
// — no coefficient values — and emits each block's absolute entry bit
// offset plus whether an EOB run covers it at entry.  The device value
// pass then re-decodes every block independently (mask-parallel) from
// those exact offsets against the device-resident store.
//
// Reference semantics: refine_block/refine_non_zeroes above
// (decoder.zig:1459-1549).  The bit reader is plain MSB-first because
// the caller already destuffed the scan (_destuff_scan).
int zpix_prog_refine_index(
    const uint8_t* stream, int64_t nbytes,
    const HuffTable* ac,      // canonical fields only (no LUT needed)
    uint8_t* nzmask,          // [nblk * 64] zigzag-order nonzero flags, in/out
    int64_t nblk,
    int32_t zig_start, int32_t zig_end,
    uint16_t eob_run_in,
    int32_t* block_bit_off,   // out [nblk]: absolute entry bit offset
    uint8_t* block_eob_entry, // out [nblk]: 1 = EOB run covers entry
    uint16_t* eob_run_out, int64_t* end_bit_out) {
  // LUT16 + word-at-a-time reads (round-5: the per-bit lambda walk was
  // ~2.7 ms per 16-image scan — the dominant host-prep cost of the
  // fused progressive path).  stream must be zero-padded by >= 8
  // readable bytes past nbytes (every real read STARTS before nbits,
  // so reads touch < 5 bytes past the end; callers pad).
  ensure_lut16(const_cast<HuffTable*>(ac));
  const int64_t nbits = nbytes * 8;
  int64_t bit = 0;
  uint32_t eob_run = eob_run_in;
  auto peek16 = [&]() -> uint32_t {
    const int64_t byte = bit >> 3;
    const uint32_t w = (uint32_t(stream[byte]) << 24)
        | (uint32_t(stream[byte + 1]) << 16)
        | (uint32_t(stream[byte + 2]) << 8) | uint32_t(stream[byte + 3]);
    return (w >> (16 - (bit & 7))) & 0xFFFF;
  };
  auto get1 = [&]() -> int {
    int b = (stream[bit >> 3] >> (7 - (bit & 7))) & 1;
    bit++;
    return b;
  };

  for (int64_t bi = 0; bi < nblk; bi++) {
    block_bit_off[bi] = int32_t(bit);
    block_eob_entry[bi] = eob_run > 0 ? 1 : 0;
    uint8_t* m = nzmask + bi * 64;
    int32_t zig = zig_start;
    if (eob_run == 0) {
      while (zig <= zig_end) {
        if (bit >= nbits) return ERR_EOF;
        uint16_t e = ac->lut16[peek16()];
        if (!e) return ERR_BAD_HUFFMAN;
        bit += e & 31;
        int value = e >> 5;
        int r = value >> 4, s = value & 0x0F;
        int newnz = 0;
        if (s == 0) {
          if (r != 0x0F) {
            eob_run = 1u << r;
            if (r) {
              uint32_t extra =
                  (peek16() >> (16 - r));  // r <= 14 run-length bits
              bit += r;
              eob_run += extra;
            }
            break;
          }
          // ZRL: r = 15 zeros crossed + the stop slot (z stays 0)
        } else if (s == 1) {
          bit++;  // sign bit of the new +-1<<Al coefficient
          newnz = 1;
        } else {
          return ERR_UNEXPECTED_CODE;
        }
        int nz = r;
        while (zig <= zig_end) {  // refine_non_zeroes, lengths only
          if (m[zig]) {
            if (bit >= nbits) return ERR_EOF;
            get1();  // correction bit of an existing nonzero
          } else {
            if (nz == 0) break;
            nz--;
          }
          zig++;
        }
        if (zig > zig_end) return ERR_TOO_MANY_COEFFS;
        if (newnz) m[zig] = 1;
        zig++;
      }
    }
    if (eob_run > 0) {
      eob_run--;
      // band tail: one correction bit per existing nonzero — a
      // branch-free mask sum (the compiler vectorizes it) instead of
      // a per-position branch + bit read; this loop visits every
      // band position of every EOB-covered block and dominated the
      // walk (~25M visits per 16-image scan)
      int32_t nc = 0;
      for (int32_t z = zig; z <= zig_end; z++) nc += m[z];
      bit += nc;
      if (bit > nbits) return ERR_EOF;
    }
  }
  *eob_run_out = uint16_t(eob_run);
  *end_bit_out = bit;
  return OK;
}

// ---------------------------------------------------------------------
// Baseline INDEX scan for restart-free streams (round-4 sync split).
//
// Speculative chunk self-sync provably converges one chunk per round on
// interleaved restart-free baseline JPEG (RESULTS.md round-3 profile),
// so the fast path is this host pass: walk the DESTUFFED scan decoding
// symbol LENGTHS only (extend bits skipped, no coefficient writes) and
// emit every 8x8 block's end bit offset; the device value pass
// (device_entropy._value_pass) then decodes all blocks in parallel
// from those exact offsets.  Length semantics mirror the device index
// pass EXACTLY (consume = code_len + size even past k=63; ZRL may end
// a block when k+16 > 63) so the device's pass-2 `agree` verification
// holds bit-for-bit.
//
// stream must be zero-padded by >= 8 readable bytes past nbytes (the
// device window reads zeros past the stream the same way).
int zpix_baseline_index_scan(
    const uint8_t* stream, int64_t nbytes,
    const HuffTable* huff,  // [8]: dc tables 0..3, ac tables 4..7
    const int32_t* slot_dc, const int32_t* slot_ac, int32_t bpm,
    int64_t n_mcu,
    int32_t* ends_out,  // [n_mcu * bpm] per-block end bit offsets
    int64_t* end_bit_out) {
  for (int32_t s = 0; s < bpm; s++) {
    ensure_lut16(const_cast<HuffTable*>(&huff[slot_dc[s]]));
    ensure_lut16(const_cast<HuffTable*>(&huff[4 + slot_ac[s]]));
  }
  const int64_t nbits = nbytes * 8;
  int64_t bit = 0;
  auto peek16 = [&]() -> uint32_t {
    const int64_t byte = bit >> 3;
    const uint32_t w = (uint32_t(stream[byte]) << 24)
        | (uint32_t(stream[byte + 1]) << 16)
        | (uint32_t(stream[byte + 2]) << 8) | uint32_t(stream[byte + 3]);
    return (w >> (16 - (bit & 7))) & 0xFFFF;
  };
  int64_t t = 0;
  for (int64_t m = 0; m < n_mcu; m++) {
    for (int32_t s = 0; s < bpm; s++) {
      if (bit >= nbits + 512) return ERR_EOF;  // runaway (corrupt stream)
      const HuffTable* hd = &huff[slot_dc[s]];
      uint16_t e = hd->lut16[peek16()];
      if (!e) return ERR_BAD_HUFFMAN;
      int val = e >> 5;
      if (val > 16) return ERR_EXCESSIVE_DC;
      bit += (e & 31) + val;  // DC code + skipped extend bits
      int k = 1;
      const HuffTable* ha = &huff[4 + slot_ac[s]];
      while (true) {
        uint16_t ea = ha->lut16[peek16()];
        if (!ea) return ERR_BAD_HUFFMAN;
        int sym = ea >> 5;
        int r = sym >> 4, sz = sym & 15;
        bit += (ea & 31) + sz;
        if (sz) {
          int ek = k + r;
          if (ek > 63) ek = 63;
          k = ek + 1;
        } else if (r == 15) {
          k += 16;
        } else {
          break;  // EOB
        }
        if (k > 63) break;
      }
      ends_out[t++] = int32_t(bit);
    }
  }
  *end_bit_out = bit;
  return OK;
}

// ---------------------------------------------------------------------
// Progressive FIRST-scan INDEX passes (round-5 host/device split).
//
// The speculative chunk fixed points that decoded DC-first/AC-first
// scans on-chip dominate progressive cost (RESULTS_r4.md); the same
// lengths-only host walk that took restart-free baseline from 40 to
// 474 MPix/s (zpix_baseline_index_scan above) applies directly.  Each
// pass walks one DESTUFFED scan decoding symbol LENGTHS only and emits
// per-block bit offsets; the device value passes
// (progressive_onchip.build_dc_first_value_fn / build_ac_first_value_fn)
// then re-decode every block independently from those exact offsets,
// and their `agree` verification (lane end == host end) re-derives the
// walk bit-for-bit.
//
// Reference semantics: /root/reference/src/jpeg/decoder.zig:1362-1412
// (spectral-selection scans); length accounting mirrors the device
// sym_step EXACTLY, including the overflow rule (a size>0 symbol with
// k+r > se ends the block consuming only its code bits).

// DC-first (Ss=0, Ah=0): one DC symbol + extend bits per block
// (decoder.zig:1366-1376).  huffs = CmpTables-ordered DC tables;
// tid_of_slot cycles through the MCU's block slots (len 1 for
// single-component scans).  ends_out[i] = absolute end bit of block i.
int zpix_prog_dc_first_index(
    const uint8_t* stream, int64_t nbytes,
    const HuffTable* huffs, const int32_t* tid_of_slot, int32_t bpm,
    int64_t nblk, int32_t* ends_out, int64_t* end_bit_out) {
  for (int32_t s = 0; s < bpm; s++)
    ensure_lut16(const_cast<HuffTable*>(&huffs[tid_of_slot[s]]));
  const int64_t nbits = nbytes * 8;
  int64_t bit = 0;
  auto peek16 = [&]() -> uint32_t {
    const int64_t byte = bit >> 3;
    const uint32_t w = (uint32_t(stream[byte]) << 24)
        | (uint32_t(stream[byte + 1]) << 16)
        | (uint32_t(stream[byte + 2]) << 8) | uint32_t(stream[byte + 3]);
    return (w >> (16 - (bit & 7))) & 0xFFFF;
  };
  int32_t slot = 0;
  for (int64_t i = 0; i < nblk; i++) {
    // every block of a valid scan STARTS before the stream end (the
    // encoder's padding bits live inside the last byte), so this also
    // bounds overread to < 5 bytes past nbytes (caller pads >= 8)
    if (bit >= nbits) return ERR_EOF;
    const HuffTable* hd = &huffs[tid_of_slot[slot]];
    uint16_t e = hd->lut16[peek16()];
    if (!e) return ERR_BAD_HUFFMAN;
    int val = e >> 5;
    if (val > 16) return ERR_EXCESSIVE_DC;
    bit += (e & 31) + val;  // code + skipped extend bits
    ends_out[i] = int32_t(bit);
    if (++slot >= bpm) slot = 0;
  }
  *end_bit_out = bit;
  return OK;
}

// AC-first (Ss>0, Ah=0, single component): per-block spectral walk with
// EOB runs (decoder.zig:1379-1412).  Emits each DATA block's [start,
// end) bit span and hasdata=1; EOB-covered blocks consume no bits and
// get hasdata=0 (the device value lane idles and skips the agree
// check).  nzmask_io (optional, [nvalid * 64] zigzag flags) accumulates
// the nonzero pattern each emitted coefficient creates, so later AC
// REFINEMENT index passes (zpix_prog_refine_index) can seed their masks
// host-side with NO device store fetch.
int zpix_prog_ac_first_index(
    const uint8_t* stream, int64_t nbytes, const HuffTable* ac,
    int32_t ss, int32_t se, int64_t nvalid,
    int32_t* starts_out, int32_t* ends_out, uint8_t* hasdata_out,
    uint8_t* nzmask_io, int64_t* end_bit_out) {
  ensure_lut16(const_cast<HuffTable*>(ac));
  const int64_t nbits = nbytes * 8;
  int64_t bit = 0;
  auto peek16 = [&]() -> uint32_t {
    const int64_t byte = bit >> 3;
    const uint32_t w = (uint32_t(stream[byte]) << 24)
        | (uint32_t(stream[byte + 1]) << 16)
        | (uint32_t(stream[byte + 2]) << 8) | uint32_t(stream[byte + 3]);
    return (w >> (16 - (bit & 7))) & 0xFFFF;
  };
  uint32_t eob_run = 0;
  for (int64_t bi = 0; bi < nvalid; bi++) {
    if (eob_run > 0) {
      eob_run--;
      starts_out[bi] = int32_t(bit);
      ends_out[bi] = int32_t(bit);
      hasdata_out[bi] = 0;
      continue;
    }
    starts_out[bi] = int32_t(bit);
    hasdata_out[bi] = 1;
    int32_t k = ss;
    while (true) {
      // valid symbols START before the stream end; bounds overread to
      // < 5 bytes past nbytes (caller pads >= 8)
      if (bit >= nbits) return ERR_EOF;
      uint16_t e = ac->lut16[peek16()];
      if (!e) return ERR_BAD_HUFFMAN;
      int sym = e >> 5;
      int len = e & 31;
      int r = sym >> 4, sz = sym & 15;
      if (sz == 0) {
        if (r < 15) {  // EOB: run-length extra bits (r <= 14) in one peek
          bit += len;
          uint32_t extra = r ? (peek16() >> (16 - r)) : 0;
          bit += r;
          eob_run = ((1u << r) | extra) - 1;  // current block included
          break;
        }
        bit += len;  // ZRL
        k += 16;
        if (k > se) break;
      } else {
        if (k + r > se) {  // device overflow rule: code bits only
          bit += len;
          break;
        }
        k += r;
        if (nzmask_io) nzmask_io[bi * 64 + k] = 1;
        bit += len + sz;
        k++;
        if (k > se) break;
      }
    }
    ends_out[bi] = int32_t(bit);
  }
  *end_bit_out = bit;
  return OK;
}

int zpix_entropy_abi_version() { return 23; }

}  // extern "C"
