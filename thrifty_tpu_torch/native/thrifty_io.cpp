// Native host I/O engine for thrifty-tpu.
//
// TPU-native replacement for the reference's C capture front-end
// (fastcard/: base64.c, rawconv.c, raw_reader.c, card_reader.c,
// circbuf.c): the DSP moved to the TPU, so the native layer's job is to
// keep the host->device input pipeline fed -- parse .card captures into
// batched arrays at memory bandwidth (multi-threaded base64), convert
// raw 8-bit IQ to float via a LUT, unfold overlap-save blocks, and pump
// unbounded streams through a lock-protected ring buffer with
// occupancy/overflow accounting (the reference's backpressure profiler,
// rtlsdr_reader.c:310-325).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define TTPU_X86 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Base64
// ---------------------------------------------------------------------------

static int8_t B64_REV[256];
// SWAR decode tables (aklomp-style): the 24-bit group is assembled with
// four table lookups and one OR; invalid characters carry bit 24 so a
// whole quad is validated with a single branch.
static uint32_t B64_D0[256], B64_D1[256], B64_D2[256], B64_D3[256];
static bool b64_init_done = false;
static std::once_flag b64_once;

static void b64_init_impl() {
    const char* alphabet =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    const uint32_t BAD = 1u << 24;
    for (int i = 0; i < 256; ++i) {
        B64_REV[i] = -1;
        B64_D0[i] = B64_D1[i] = B64_D2[i] = B64_D3[i] = BAD;
    }
    for (uint32_t v = 0; v < 64; ++v) {
        uint8_t c = (uint8_t)alphabet[v];
        B64_REV[c] = (int8_t)v;
        // Decoded bytes: b0 = v0<<2 | v1>>4, b1 = v1<<4 | v2>>2,
        // b2 = v2<<6 | v3.  Stored as little-endian contributions to
        // X = b0 | b1<<8 | b2<<16 so one 32-bit store emits the group.
        B64_D0[c] = v << 2;
        B64_D1[c] = (v >> 4) | ((v & 0x0F) << 12);
        B64_D2[c] = ((v >> 2) << 8) | ((v & 0x03) << 22);
        B64_D3[c] = v << 16;
    }
    B64_REV[(uint8_t)'='] = -2;
    b64_init_done = true;
}

// Thread-safe: worker threads of the batch decoder and the parallel
// scan may race to initialize in a fresh process.
static void b64_init() { std::call_once(b64_once, b64_init_impl); }

#ifdef TTPU_X86
// AVX2 fast path: 32 base64 chars -> 24 bytes per iteration.
//
// Character classification is done with plain signed byte compares
// against the five alphabet ranges (A-Z, a-z, 0-9, '+', '/') and the
// per-range ASCII->value delta is blended in; any byte outside every
// range aborts to the scalar path (which also handles '=' padding).
// The 6-bit values are packed with the two-step maddubs/madd merge:
//   16-bit lane = v_even<<6 | v_odd, 32-bit lane = quad<<12 merge,
// giving the 24-bit group in bytes [2,1,0] of each dword; an in-lane
// pshufb + cross-lane permute compacts the 4x3 bytes per 128-bit lane
// into 24 contiguous output bytes.
__attribute__((target("avx2")))
static int64_t b64_decode_avx2(const char* in, int64_t in_len,
                               uint8_t* out, int64_t out_cap,
                               int64_t* out_written) {
    int64_t i = 0, o = 0;
    const __m256i c_A = _mm256_set1_epi8('A' - 1);
    const __m256i c_Z = _mm256_set1_epi8('Z' + 1);
    const __m256i c_a = _mm256_set1_epi8('a' - 1);
    const __m256i c_z = _mm256_set1_epi8('z' + 1);
    const __m256i c_0 = _mm256_set1_epi8('0' - 1);
    const __m256i c_9 = _mm256_set1_epi8('9' + 1);
    const __m256i c_plus = _mm256_set1_epi8('+');
    const __m256i c_slash = _mm256_set1_epi8('/');
    const __m256i d_upper = _mm256_set1_epi8(-65);   // 'A' -> 0
    const __m256i d_lower = _mm256_set1_epi8(-71);   // 'a' -> 26
    const __m256i d_digit = _mm256_set1_epi8(4);     // '0' -> 52
    const __m256i d_plus = _mm256_set1_epi8(19);     // '+' -> 62
    const __m256i d_slash = _mm256_set1_epi8(16);    // '/' -> 63
    const __m256i merge16 = _mm256_set1_epi32(0x01400140);
    const __m256i merge32 = _mm256_set1_epi32(0x00011000);
    const __m256i pack = _mm256_setr_epi8(
        2, 1, 0, 6, 5, 4, 10, 9, 8, 14, 13, 12, -1, -1, -1, -1,
        2, 1, 0, 6, 5, 4, 10, 9, 8, 14, 13, 12, -1, -1, -1, -1);
    const __m256i lanes = _mm256_setr_epi32(0, 1, 2, 4, 5, 6, 7, 7);

    while (i + 32 <= in_len && o + 32 <= out_cap) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(in + i));
        __m256i up = _mm256_and_si256(_mm256_cmpgt_epi8(x, c_A),
                                      _mm256_cmpgt_epi8(c_Z, x));
        __m256i lo = _mm256_and_si256(_mm256_cmpgt_epi8(x, c_a),
                                      _mm256_cmpgt_epi8(c_z, x));
        __m256i di = _mm256_and_si256(_mm256_cmpgt_epi8(x, c_0),
                                      _mm256_cmpgt_epi8(c_9, x));
        __m256i pl = _mm256_cmpeq_epi8(x, c_plus);
        __m256i sl = _mm256_cmpeq_epi8(x, c_slash);
        __m256i any = _mm256_or_si256(
            _mm256_or_si256(_mm256_or_si256(up, lo), di),
            _mm256_or_si256(pl, sl));
        if (_mm256_movemask_epi8(any) != -1)
            break;  // padding / junk: scalar tail handles it
        __m256i delta = _mm256_or_si256(
            _mm256_or_si256(_mm256_and_si256(up, d_upper),
                            _mm256_and_si256(lo, d_lower)),
            _mm256_or_si256(
                _mm256_and_si256(di, d_digit),
                _mm256_or_si256(_mm256_and_si256(pl, d_plus),
                                _mm256_and_si256(sl, d_slash))));
        __m256i v = _mm256_add_epi8(x, delta);  // 6-bit values
        __m256i m16 = _mm256_maddubs_epi16(v, merge16);
        __m256i m32 = _mm256_madd_epi16(m16, merge32);
        __m256i packed = _mm256_shuffle_epi8(m32, pack);
        __m256i outv = _mm256_permutevar8x32_epi32(packed, lanes);
        _mm256_storeu_si256((__m256i*)(out + o), outv);
        i += 32;
        o += 24;
    }
    *out_written = o;
    return i;
}

static bool b64_have_avx2() {
    // C++11 magic static: initialization is thread-safe, unlike a
    // mutable cache written racily from the batch-decode workers.
    static const bool ok = __builtin_cpu_supports("avx2") != 0;
    return ok;
}
#endif  // TTPU_X86

// Decode one base64 string; returns decoded byte count or -1 on error.
int ttpu_b64_decode(const char* in, int64_t in_len, uint8_t* out,
                    int64_t out_cap) {
    b64_init();
    int64_t o = 0;
    int64_t i = 0;
#ifdef TTPU_X86
    if (b64_have_avx2()) {
        int64_t wrote = 0;
        i = b64_decode_avx2(in, in_len, out, out_cap, &wrote);
        o = wrote;
    }
#endif
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    // Fast path (little-endian only: the 32-bit store's byte order is
    // part of the table encoding): whole 4-char groups with >=4 bytes
    // of output slack (one scratch byte past the 3 real ones).
    while (i + 4 <= in_len && o + 4 <= out_cap) {
        uint32_t v = B64_D0[(uint8_t)in[i]] | B64_D1[(uint8_t)in[i + 1]]
                   | B64_D2[(uint8_t)in[i + 2]]
                   | B64_D3[(uint8_t)in[i + 3]];
        if (v & (1u << 24)) break;  // padding or junk: slow path
        memcpy(out + o, &v, 4);
        o += 3;
        i += 4;
    }
#endif
    // Slow path: remaining chars, padding, validation.
    uint32_t acc = 0;
    int bits = 0;
    for (; i < in_len; ++i) {
        int8_t v = B64_REV[(uint8_t)in[i]];
        if (v == -2) break;            // padding: done
        if (v < 0) return -1;          // invalid character
        acc = (acc << 6) | (uint32_t)v;
        bits += 6;
        if (bits >= 8) {
            bits -= 8;
            if (o >= out_cap) return -1;
            out[o++] = (uint8_t)((acc >> bits) & 0xFF);
        }
    }
    return (int)o;
}

int ttpu_b64_encode(const uint8_t* in, int64_t in_len, char* out,
                    int64_t out_cap) {
    static const char* alphabet =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    int64_t o = 0;
    int64_t i = 0;
    if (out_cap < ((in_len + 2) / 3) * 4 + 1) return -1;
    for (; i + 2 < in_len; i += 3) {
        uint32_t v = (uint32_t)(in[i] << 16 | in[i + 1] << 8 | in[i + 2]);
        out[o++] = alphabet[(v >> 18) & 63];
        out[o++] = alphabet[(v >> 12) & 63];
        out[o++] = alphabet[(v >> 6) & 63];
        out[o++] = alphabet[v & 63];
    }
    if (i < in_len) {
        uint32_t v = (uint32_t)(in[i] << 16);
        bool two = (i + 1 < in_len);
        if (two) v |= (uint32_t)(in[i + 1] << 8);
        out[o++] = alphabet[(v >> 18) & 63];
        out[o++] = alphabet[(v >> 12) & 63];
        out[o++] = two ? alphabet[(v >> 6) & 63] : '=';
        out[o++] = '=';
    }
    out[o] = 0;
    return (int)o;
}

// Decode n equal-length base64 payloads into a [n, block_bytes] array,
// multi-threaded.  offsets[i]/lens[i] index into `text`.  status[i] is
// set to 0 when row i decoded to exactly block_bytes, 1 otherwise
// (junk rows are the caller's to drop).  Returns the number of bad rows.
int64_t ttpu_b64_decode_batch(const char* text, const int64_t* offsets,
                              const int64_t* lens, int64_t n,
                              uint8_t* out, int64_t block_bytes,
                              uint8_t* status, int num_threads) {
    b64_init();
    std::atomic<int64_t> bad(0);
    if (num_threads < 1) num_threads = 1;
    std::vector<std::thread> threads;
    auto work = [&](int64_t t) {
        int64_t my_bad = 0;
        for (int64_t i = t; i < n; i += num_threads) {
            int got = ttpu_b64_decode(text + offsets[i], lens[i],
                                      out + i * block_bytes, block_bytes);
            status[i] = (got == block_bytes) ? 0 : 1;
            my_bad += status[i];
        }
        bad += my_bad;
    };
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
    return bad.load();
}

// ---------------------------------------------------------------------------
// .card parsing
// ---------------------------------------------------------------------------

// Count newlines (memchr sweep; CPython's bytes.count measures ~1 GB/s
// on this class of host, this runs at memory bandwidth).
int64_t ttpu_count_newlines(const char* text, int64_t text_len) {
    int64_t count = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl) break;
        ++count;
        p = nl + 1;
    }
    return count;
}

// Parse one data line [line_start, line_end); fills the four fields
// and returns true when the line is a valid "<ts> <idx> <b64>" record.
// Shared core of the direct and parallel scans; callers must have run
// b64_init().
static bool card_parse_line(const char* text, int64_t line_start,
                            int64_t line_end, double* ts_out,
                            int64_t* idx_out, int64_t* off_out,
                            int64_t* len_out) {
    if (line_end <= line_start) return false;
    const char* line = text + line_start;
    if (line[0] == '#' || line[0] == '\n' || line[0] == '\r') return false;
    // Parse "<float> <int> <payload>".
    char* endp = nullptr;
    double ts = strtod(line, &endp);
    if (endp == line || endp >= text + line_end || *endp != ' ')
        return false;
    char* endp2 = nullptr;
    long long idx = strtoll(endp + 1, &endp2, 10);
    if (endp2 == endp + 1 || endp2 >= text + line_end || *endp2 != ' ')
        return false;
    const char* payload = endp2 + 1;
    int64_t plen = (text + line_end) - payload;
    while (plen > 0 && (payload[plen - 1] == '\r')) --plen;
    if (plen <= 0) return false;
    // Bound the payload at the first whitespace (base64 has none;
    // junk lines can carry trailing tokens).  Full validation is
    // deferred to the decoder, which flags junk rows per row --
    // validating every character here would double the scan cost.
    const char* sp = (const char*)memchr(payload, ' ', plen);
    if (sp) plen = sp - payload;
    if (plen <= 0 || B64_REV[(uint8_t)payload[0]] < 0) return false;
    *ts_out = ts;
    *idx_out = (int64_t)idx;
    *off_out = payload - text;
    *len_out = plen;
    return true;
}

// Scan one [pos, stop) range into the provided vectors (parallel-scan
// worker).  ``pos`` must sit at a line start.
static void card_scan_range(const char* text, int64_t pos, int64_t stop,
                            std::vector<double>& timestamps,
                            std::vector<int64_t>& indices,
                            std::vector<int64_t>& payload_offsets,
                            std::vector<int64_t>& payload_lens) {
    double ts;
    int64_t idx, off, len;
    while (pos < stop) {
        int64_t line_start = pos;
        const char* nl = (const char*)memchr(text + pos, '\n', stop - pos);
        int64_t line_end = nl ? (nl - text) : stop;
        pos = line_end + 1;
        if (card_parse_line(text, line_start, line_end, &ts, &idx,
                            &off, &len)) {
            timestamps.push_back(ts);
            indices.push_back(idx);
            payload_offsets.push_back(off);
            payload_lens.push_back(len);
        }
    }
}

// Scan one range straight into caller arrays, stopping at max_blocks.
static int64_t card_scan_direct(const char* text, int64_t pos,
                                int64_t stop, double* timestamps,
                                int64_t* indices,
                                int64_t* payload_offsets,
                                int64_t* payload_lens,
                                int64_t max_blocks) {
    int64_t count = 0;
    while (pos < stop && count < max_blocks) {
        int64_t line_start = pos;
        const char* nl = (const char*)memchr(text + pos, '\n', stop - pos);
        int64_t line_end = nl ? (nl - text) : stop;
        pos = line_end + 1;
        if (card_parse_line(text, line_start, line_end,
                            timestamps + count, indices + count,
                            payload_offsets + count,
                            payload_lens + count)) {
            ++count;
        }
    }
    return count;
}

// Scan a .card text buffer: find data lines "<ts> <idx> <b64>" and fill
// timestamps/indices plus the base64 payload offsets/lengths.  Returns
// the number of blocks found (<= max_blocks).  With num_threads > 1
// the buffer is split at line boundaries and scanned in parallel
// (strtod-heavy, ~900 MB/s/thread), results merged in order.
//
// REQUIRES text[text_len] == '\0': the number parser uses
// strtod/strtoll, which scan until a non-number byte -- on the final
// line they may read past text_len (the result is rejected by the
// bounds check, but the read itself needs the terminator).  The
// Python wrapper satisfies this because ctypes `bytes` arguments are
// always NUL-terminated; C callers passing a raw slice must copy or
// terminate it first.
int64_t ttpu_card_scan_mt(const char* text, int64_t text_len,
                          double* timestamps, int64_t* indices,
                          int64_t* payload_offsets, int64_t* payload_lens,
                          int64_t max_blocks, int num_threads) {
    b64_init();  // before any worker thread touches the tables
    if (num_threads < 1) num_threads = 1;
    if (text_len < (1 << 20)) num_threads = 1;  // not worth the threads

    if (num_threads == 1) {
        // Direct path: write straight into the caller's arrays (no
        // vectors, no merge copy, no thread), stopping at max_blocks.
        return card_scan_direct(text, 0, text_len, timestamps, indices,
                                payload_offsets, payload_lens,
                                max_blocks);
    }

    // Chunk boundaries snapped forward to line starts.
    std::vector<int64_t> starts(num_threads + 1, text_len);
    starts[0] = 0;
    for (int t = 1; t < num_threads; ++t) {
        int64_t p = text_len * t / num_threads;
        const char* nl = (const char*)memchr(text + p, '\n', text_len - p);
        starts[t] = nl ? (nl - text) + 1 : text_len;
    }
    std::vector<std::vector<double>> ts_v(num_threads);
    std::vector<std::vector<int64_t>> idx_v(num_threads), off_v(num_threads),
        len_v(num_threads);
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) {
        threads.emplace_back([&, t]() {
            card_scan_range(text, starts[t], starts[t + 1],
                            ts_v[t], idx_v[t], off_v[t], len_v[t]);
        });
    }
    for (auto& th : threads) th.join();

    int64_t count = 0;
    for (int t = 0; t < num_threads && count < max_blocks; ++t) {
        int64_t n = (int64_t)ts_v[t].size();
        if (n > max_blocks - count) n = max_blocks - count;
        if (n <= 0) continue;  // empty chunk: data() may be null
        memcpy(timestamps + count, ts_v[t].data(), n * sizeof(double));
        memcpy(indices + count, idx_v[t].data(), n * sizeof(int64_t));
        memcpy(payload_offsets + count, off_v[t].data(),
               n * sizeof(int64_t));
        memcpy(payload_lens + count, len_v[t].data(), n * sizeof(int64_t));
        count += n;
    }
    return count;
}

int64_t ttpu_card_scan(const char* text, int64_t text_len,
                       double* timestamps, int64_t* indices,
                       int64_t* payload_offsets, int64_t* payload_lens,
                       int64_t max_blocks) {
    return ttpu_card_scan_mt(text, text_len, timestamps, indices,
                             payload_offsets, payload_lens, max_blocks, 1);
}

// ---------------------------------------------------------------------------
// Raw 8-bit IQ -> float conversion (LUT, cf. fastcard/rawconv.c)
// ---------------------------------------------------------------------------

static float IQ_LUT[256];
static std::once_flag lut_once;

// Thread-safe like b64_init: two Python threads may enter
// ttpu_raw_to_iq concurrently (ctypes releases the GIL), and a plain
// bool flag would not order the table stores before the flag store.
static void lut_init() {
    std::call_once(lut_once, [] {
        for (int i = 0; i < 256; ++i)
            IQ_LUT[i] = ((float)i - 127.4f) * (1.0f / 128.0f);
    });
}

// Convert n_bytes of interleaved uint8 IQ to n_bytes floats (pairs of
// which form complex64), multi-threaded for large batches.
void ttpu_raw_to_iq(const uint8_t* raw, float* out, int64_t n_bytes,
                    int num_threads) {
    lut_init();
    if (num_threads < 1) num_threads = 1;
    if (num_threads == 1 || n_bytes < (1 << 20)) {
        for (int64_t i = 0; i < n_bytes; ++i) out[i] = IQ_LUT[raw[i]];
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_bytes + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n_bytes ? lo + chunk : n_bytes;
        if (lo >= hi) break;
        threads.emplace_back([=]() {
            for (int64_t i = lo; i < hi; ++i) out[i] = IQ_LUT[raw[i]];
        });
    }
    for (auto& th : threads) th.join();
}

// Overlap-save unfold: contiguous stream bytes [total] -> blocks
// [num_blocks, block_bytes] where each block repeats the previous
// history_bytes (cf. fastcard/raw_reader.c:22-30).  The first block is
// prefixed with `fill` (128 = zero signal).
void ttpu_unfold(const uint8_t* stream, int64_t total_bytes,
                 uint8_t* out, int64_t block_bytes, int64_t history_bytes,
                 int64_t num_blocks, uint8_t fill) {
    int64_t new_bytes = block_bytes - history_bytes;
    for (int64_t b = 0; b < num_blocks; ++b) {
        int64_t start = b * new_bytes - history_bytes;
        uint8_t* dst = out + b * block_bytes;
        // Bulk row copy (the per-byte bounds-checked loop this
        // replaces was the same ~75 MB/s trap as the old ring copy):
        // fill the out-of-stream head/tail, memcpy the middle.
        int64_t j0 = start < 0 ? -start : 0;
        if (j0 > block_bytes) j0 = block_bytes;  // history > block row
        int64_t j1 = start + block_bytes > total_bytes
                         ? total_bytes - start
                         : block_bytes;
        if (j1 < j0) j1 = j0;
        if (j0 > 0) memset(dst, fill, (size_t)j0);
        if (j1 > j0) memcpy(dst + j0, stream + start + j0,
                            (size_t)(j1 - j0));
        if (j1 < block_bytes)
            memset(dst + j1, fill, (size_t)(block_bytes - j1));
    }
}

// Strided row gather: out[r][0..row_bytes) = src[r*src_stride ..) --
// the hot copy of the mmap one-copy ingest path, where overlap-save
// rows are pulled straight out of the page cache.  Row-parallel:
// threads own contiguous, disjoint row ranges, so the only shared
// state is the read-only source.  A single memcpy stream tops out at
// one core's copy bandwidth; rows are independent, so this is the
// cheap way past that bound.
void ttpu_copy_rows(const uint8_t* src, uint8_t* out, int64_t row_bytes,
                    int64_t src_stride, int64_t num_rows,
                    int num_threads) {
    if (num_threads < 1) num_threads = 1;
    if (num_threads == 1 || num_rows * row_bytes < (1 << 21)) {
        for (int64_t r = 0; r < num_rows; ++r)
            memcpy(out + r * row_bytes, src + r * src_stride,
                   (size_t)row_bytes);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (num_rows + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < num_rows ? lo + chunk : num_rows;
        if (lo >= hi) break;
        threads.emplace_back([=]() {
            for (int64_t r = lo; r < hi; ++r)
                memcpy(out + r * row_bytes, src + r * src_stride,
                       (size_t)row_bytes);
        });
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Ring buffer (cf. fastcard/circbuf.c): producer/consumer with
// occupancy histogram and overflow counter.
// ---------------------------------------------------------------------------

struct ttpu_ring {
    std::vector<uint8_t> buf;
    size_t head = 0, tail = 0, size = 0;
    std::mutex mu;
    std::condition_variable can_read, can_write;
    bool closed = false;
    uint64_t overflows = 0;
    uint64_t histogram[8] = {0};
};

void* ttpu_ring_new(int64_t capacity) {
    auto* r = new ttpu_ring();
    r->buf.resize((size_t)capacity);
    return r;
}

void ttpu_ring_free(void* ring) { delete (ttpu_ring*)ring; }

void ttpu_ring_close(void* ring) {
    auto* r = (ttpu_ring*)ring;
    std::lock_guard<std::mutex> lock(r->mu);
    r->closed = true;
    r->can_read.notify_all();
    r->can_write.notify_all();
}

// Blocking write; returns bytes written (< len only if closed).
int64_t ttpu_ring_write(void* ring, const uint8_t* data, int64_t len) {
    auto* r = (ttpu_ring*)ring;
    int64_t written = 0;
    std::unique_lock<std::mutex> lock(r->mu);
    while (written < len) {
        if (r->size == r->buf.size()) {
            ++r->overflows;  // producer stalls: real-time margin exceeded
            r->can_write.wait(lock, [&] {
                return r->size < r->buf.size() || r->closed;
            });
        }
        if (r->closed) break;
        size_t space = r->buf.size() - r->size;
        size_t n = std::min((size_t)(len - written), space);
        // Wrap-aware bulk copy (a per-byte loop with a modulo per byte
        // caps the whole ingest path at ~75 MB/s).
        size_t first = std::min(n, r->buf.size() - r->head);
        memcpy(r->buf.data() + r->head, data + written, first);
        if (n > first)
            memcpy(r->buf.data(), data + written + first, n - first);
        r->head = (r->head + n) % r->buf.size();
        r->size += n;
        written += (int64_t)n;
        r->histogram[(r->size * 8 - 1) / r->buf.size() < 8
                         ? (r->size * 8 - 1) / r->buf.size() : 7]++;
        r->can_read.notify_all();
    }
    return written;
}

// Zero-copy producer API: reserve a contiguous writable span inside
// ring memory (so the source can readinto() it directly -- one copy
// from the kernel into the ring instead of kernel -> scratch bytes ->
// ring), then commit what was actually filled.  Single producer.
// Blocks until >= 1 byte of space or close; returns the span length
// (0 iff closed) and its start via *offset (an offset into the ring's
// base, see ttpu_ring_base).  The span never wraps: a wrap point just
// yields a shorter span and the next reserve starts at 0.
int64_t ttpu_ring_write_reserve(void* ring, int64_t max_len,
                                int64_t* offset) {
    auto* r = (ttpu_ring*)ring;
    std::unique_lock<std::mutex> lock(r->mu);
    if (r->size == r->buf.size() && !r->closed)
        ++r->overflows;  // producer stalls: real-time margin exceeded
    r->can_write.wait(lock, [&] {
        return r->size < r->buf.size() || r->closed;
    });
    if (r->closed) return 0;
    size_t space = r->buf.size() - r->size;
    size_t n = std::min((size_t)max_len,
                        std::min(space, r->buf.size() - r->head));
    *offset = (int64_t)r->head;
    return (int64_t)n;
}

// Publish n bytes previously written into the reserved span.
void ttpu_ring_write_commit(void* ring, int64_t n) {
    auto* r = (ttpu_ring*)ring;
    std::lock_guard<std::mutex> lock(r->mu);
    r->head = (r->head + (size_t)n) % r->buf.size();
    r->size += (size_t)n;
    if (n > 0)
        r->histogram[(r->size * 8 - 1) / r->buf.size() < 8
                         ? (r->size * 8 - 1) / r->buf.size() : 7]++;
    r->can_read.notify_all();
}

uint8_t* ttpu_ring_base(void* ring) {
    return ((ttpu_ring*)ring)->buf.data();
}

// Blocking read of exactly len bytes; returns bytes read (< len only at
// end-of-stream after close).
int64_t ttpu_ring_read(void* ring, uint8_t* out, int64_t len) {
    auto* r = (ttpu_ring*)ring;
    int64_t got = 0;
    std::unique_lock<std::mutex> lock(r->mu);
    while (got < len) {
        if (r->size == 0) {
            if (r->closed) break;
            r->can_read.wait(lock,
                             [&] { return r->size > 0 || r->closed; });
            if (r->size == 0 && r->closed) break;
        }
        size_t n = std::min((size_t)(len - got), r->size);
        size_t first = std::min(n, r->buf.size() - r->tail);
        memcpy(out + got, r->buf.data() + r->tail, first);
        if (n > first)
            memcpy(out + got + first, r->buf.data(), n - first);
        r->tail = (r->tail + n) % r->buf.size();
        r->size -= n;
        got += (int64_t)n;
        r->can_write.notify_all();
    }
    return got;
}

// Fused blocking read + overlap-save unfold straight out of ring
// memory: removes the intermediate linear staging buffer (one full
// stream copy) from the ingest path.  Waits until max_blocks *
// (block_bytes - history_bytes) bytes are buffered (or the ring is
// closed), then writes each complete block row directly from the ring
// with wrap-aware memcpys and consumes exactly the unfolded bytes.
//
// Row 0's history region is NOT written (the caller splices the
// previous batch's tail over it); rows 1+ take their history from the
// stream itself, which requires history_bytes <= new_bytes (true for
// every supported geometry; callers fall back to read+unfold
// otherwise).  Returns the number of complete blocks; *bytes_got gets
// the raw byte count read (so a short batch signals end-of-stream
// exactly like ttpu_ring_read).
int64_t ttpu_ring_read_unfold(void* ring, uint8_t* out,
                              int64_t block_bytes, int64_t history_bytes,
                              int64_t max_blocks, int64_t* bytes_got,
                              int num_threads) {
    auto* r = (ttpu_ring*)ring;
    int64_t new_bytes = block_bytes - history_bytes;
    int64_t want = max_blocks * new_bytes;
    const size_t cap = r->buf.size();
    size_t tail_snap;
    int64_t m;
    {
        std::unique_lock<std::mutex> lock(r->mu);
        while ((int64_t)r->size < want && !r->closed)
            r->can_read.wait(lock,
                             [&] { return (int64_t)r->size >= want ||
                                          r->closed; });
        m = std::min((int64_t)r->size, want);
        tail_snap = r->tail;
    }
    // Copy WITHOUT the lock: [tail, tail + m) is unread data the
    // producer can never overwrite until tail advances (single
    // consumer), so the producer keeps filling the ring while the ~2x
    // stream volume of row copies runs -- holding the mutex here was
    // measured to serialize producer and consumer and cost ~40% of
    // ingest throughput.
    int64_t blocks = m / new_bytes;
    auto copy_out = [&](int64_t logical, uint8_t* dst, int64_t n) {
        size_t pos = (tail_snap + (size_t)logical) % cap;
        size_t first = std::min((size_t)n, cap - pos);
        memcpy(dst, r->buf.data() + pos, first);
        if ((size_t)n > first)
            memcpy(dst + first, r->buf.data(), (size_t)n - first);
    };
    auto copy_range = [&](int64_t b_lo, int64_t b_hi) {
        for (int64_t b = b_lo; b < b_hi; ++b) {
            int64_t start = b * new_bytes - history_bytes;
            uint8_t* dst = out + b * block_bytes;
            if (b == 0)  // history spliced by the caller
                copy_out(0, dst + history_bytes, new_bytes);
            else
                copy_out(start, dst, block_bytes);
        }
    };
    // Row-parallel like ttpu_copy_rows (the snapshot region is
    // immutable and destinations are disjoint), but leave a core for
    // the producer thread feeding the ring.
    if (num_threads > 1 && blocks * block_bytes >= (1 << 21)) {
        std::vector<std::thread> threads;
        int64_t chunk = (blocks + num_threads - 1) / num_threads;
        for (int t = 0; t < num_threads; ++t) {
            int64_t lo = t * chunk;
            int64_t hi = lo + chunk < blocks ? lo + chunk : blocks;
            if (lo >= hi) break;
            threads.emplace_back(copy_range, lo, hi);
        }
        for (auto& th : threads) th.join();
    } else {
        copy_range(0, blocks);
    }
    int64_t consumed = blocks * new_bytes;
    {
        std::lock_guard<std::mutex> lock(r->mu);
        r->tail = (r->tail + (size_t)consumed) % cap;
        r->size -= (size_t)consumed;
        r->can_write.notify_all();
    }
    if (bytes_got) *bytes_got = m;
    return blocks;
}

uint64_t ttpu_ring_overflows(void* ring) {
    auto* r = (ttpu_ring*)ring;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->overflows;
}

void ttpu_ring_histogram(void* ring, uint64_t* out8) {
    auto* r = (ttpu_ring*)ring;
    std::lock_guard<std::mutex> lock(r->mu);
    for (int i = 0; i < 8; ++i) out8[i] = r->histogram[i];
}

}  // extern "C"
