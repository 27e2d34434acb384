// K1: Parquet RLE / bit-packed hybrid run expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/pallas/decode.py::_unpack_body
// (launched by _unpack_call once per bit-packed run, with one jnp.full per
// RLE run and a concatenate).  This kernel expands the runs of a whole
// BATCH of pages -- every dictionary page of a column chunk -- in one
// launch.  The host parses the run headers
// (io/parquet_native.py::split_hybrid_runs) into one int32 table of rows
//     {out_off, count | bw << 26, byte_off, nbytes (packed) or value (RLE)}
// (pallas/decode.py::batch_run_table); bw == 0 marks an RLE row.  The
// width is per row because writers grow the index width with the
// dictionary from page to page of one chunk.  Out offsets run on from
// page to page and byte offsets point into one buffer holding every
// page's stream, so a page boundary is just the next row.  Each packed
// row's nbytes is clipped to its page's stream: bytes past it read as 0,
// as the reference zero-pads a short payload.  Values no row covers are 0.
//
// Bound on this card: memory.  It must read the packed payload and the
// table once and write 4 bytes per value; least time =
// (payload bytes + 16 * rows + 4 * values) / 3.35 TB/s.  A first version
// made one value per thread and reached a third of that: its time did
// not depend on the width, so the per-value work set the pace (a binary
// search over the whole table, six int64 loads, four dependent byte loads
// and 64-bit index arithmetic per value).  This design moves that work
// from the value to the tile, and a tile's dependent trips to memory
// down to about one:
//   * a block owns a tile of kTile consecutive output values.  It guesses
//     the tile's first row from the mean row length and loads a window of
//     rows around the guess; the window is also the first batch of the
//     tile's rows (a warp search and more batches when the guess misses);
//   * in the same trip it copies into shared memory, with cp.async, the
//     payload span the tile most likely needs (its share of the buffer in
//     proportion to its values, a little wider), aligned down and up on
//     absolute addresses (the buffer need not be aligned; the ragged ends
//     and bytes outside the buffer are copied byte by byte, as 0 outside).
//     If the rows show that the guess missed bytes, the needed span is
//     copied after all;
//   * the rows that overlap the tile (up to kRunCap) are reduced once to
//     per-row constants (value limit, bit base relative to the staged
//     bytes, payload end) and kept in shared memory;
//   * each thread makes kGroups groups of 4 consecutive values: it finds
//     a group's row by a search over the staged rows, and a value is one
//     funnel shift of two shared-memory words; each group is one 16-byte
//     store, whole warps writing 512 contiguous bytes;
//   * per-value index arithmetic is 32-bit (the wrapper keeps every
//     buffer offset and value count below 2^31).
// A tile with more than kRunCap rows (runs of under 4 values on average)
// or whose bytes span more than kPayCap reads rows and bytes from device
// memory instead: slower, same values.
//
// Tried on the card and slower or no faster: tiles of 2048 and 8192
// values, persistent blocks that prefetch the next tile's rows, a
// per-chunk row map, folding the span per warp before the shared atomics,
// and forcing 7 blocks a multiprocessor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                              // values per store
constexpr int kGroups = 4;                             // stores per thread
constexpr int kTile = kGroups * kGroup * kThreads;     // 4096 values
constexpr int kRunCap = 1024;                          // staged rows
constexpr int kMargin = 16;                            // rows, see below
constexpr int kSlack = 256;                            // bytes, see below
constexpr int kPayCap = 4 * kTile;                     // staged bytes
constexpr uint32_t kCountMask = (1u << 26) - 1u;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
    return a > b ? a : b;
}

// A row reduced for one tile: {out_off, limit | bw << 26, f2, f3}.
// limit: values k >= limit of the row are 0.  RLE: f2 = value.  Packed,
// bytes staged: f2 = bit position of value 0 relative to the staged span
// (mod 2^32), f3 = payload end in bits relative to the span.  Packed, not
// staged: f2 = payload start, f3 = payload end, as buffer indices.
__device__ __forceinline__ uint4 reduce_row(int4 raw, int64_t base,
                                            int64_t buf_len, int64_t lo16,
                                            int64_t span, bool staged) {
    const uint32_t cw = static_cast<uint32_t>(raw.y);
    const uint32_t bw = cw >> 26;
    const uint32_t count = cw & kCountMask;
    uint4 row;
    row.x = static_cast<uint32_t>(raw.x);
    if (bw == 0) {
        row.y = count;
        row.z = static_cast<uint32_t>(raw.w);
        row.w = 0;
        return row;
    }
    const int64_t start = base + static_cast<uint32_t>(raw.z);
    const int64_t end = min64(start + static_cast<uint32_t>(raw.w), buf_len);
    const int64_t avail = end > start ? end - start : 0;
    // values whose first bit lies inside the payload
    const int64_t kmax = (avail * 8 + bw - 1) / bw;
    row.y = static_cast<uint32_t>(min64(count, kmax)) | (bw << 26);
    if (staged) {
        row.z = static_cast<uint32_t>((start - lo16) * 8);
        const int64_t e = min64(max64(end - lo16, 0), span);
        row.w = static_cast<uint32_t>(e * 8);
    } else {
        row.z = static_cast<uint32_t>(min64(start, buf_len));
        row.w = static_cast<uint32_t>(end > 0 ? end : 0);
    }
    return row;
}

// Last row r with table[r].out_off <= x, searched by one whole warp:
// each round 32 lanes probe evenly spaced rows (out_off[0] == 0 <= x).
__device__ __forceinline__ int first_row(const int4* __restrict__ table,
                                         int nrows, uint32_t x) {
    const int lane = threadIdx.x & 31;
    const int* out_off = reinterpret_cast<const int*>(table);
    int lo = 0, n = nrows;
    while (n > 1) {
        const int step = (n + 31) >> 5;
        const int p = lane * step;
        const bool ok = p < n && static_cast<uint32_t>(
                                     __ldg(out_off + 4 * (lo + p))) <= x;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        const int last = 31 - __clz(m);
        lo += last * step;
        n = min(step, n - last * step);
    }
    return lo;
}

// Keep raw row number idx of the tile in shared memory (up to kRunCap)
// and widen the span [*lo, *hi) of payload bytes the tile needs by it.
__device__ __forceinline__ void stage_row(int4 raw, int idx, uint32_t t0,
                                          uint32_t t1, int64_t base,
                                          int64_t buf_len, uint4* s_row,
                                          uint32_t* lo, uint32_t* hi) {
    if (idx < kRunCap) s_row[idx] = make_uint4(raw.x, raw.y, raw.z, raw.w);
    const uint32_t a = static_cast<uint32_t>(raw.x);
    const uint32_t cw = static_cast<uint32_t>(raw.y);
    const uint32_t bw = cw >> 26;
    const uint32_t kb = t0 > a ? t0 - a : 0;
    const uint32_t ke = min(t1 - a, cw & kCountMask);
    if (bw == 0 || ke <= kb) return;
    const int64_t start = base + static_cast<uint32_t>(raw.z);
    const int64_t end = min64(start + static_cast<uint32_t>(raw.w), buf_len);
    const int64_t need_lo = start + ((int64_t{kb} * bw) >> 3);
    const int64_t need_hi = min64(start + ((int64_t{ke} * bw + 7) >> 3), end);
    if (need_hi > need_lo) {
        atomicMin(lo, static_cast<uint32_t>(need_lo));
        atomicMax(hi, static_cast<uint32_t>(need_hi));
    }
}

// Start copying the buffer's bytes [lo16, lo16 + 16 * n) into s_pay; lo16
// lies on a 16-byte boundary of absolute addresses.  Whole 16-byte pieces
// inside the buffer copy asynchronously (cp.async; wait_copies() waits for
// this thread's), the ragged ends byte by byte, as 0 outside the buffer.
// Piece c is always this thread's, whatever lo16.
__device__ __forceinline__ void copy_span(const uint8_t* __restrict__ buf,
                                          int64_t len, int64_t lo16, int n,
                                          uint4* s_pay, int tid) {
    for (int c = tid; c < n; c += kThreads) {
        const int64_t p = lo16 + 16 * c;
        if (p >= 0 && p + 16 <= len) {
            const uint32_t dst = static_cast<uint32_t>(
                __cvta_generic_to_shared(s_pay + c));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         ::"r"(dst), "l"(buf + p) : "memory");
        } else {
            uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (p + j >= 0 && p + j < len) {
                    w[j >> 2] |= static_cast<uint32_t>(buf[p + j])
                                 << (8 * (j & 3));
                }
            }
            s_pay[c] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

__device__ __forceinline__ void wait_copies() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// [lo, hi) widened to 16-byte boundaries of absolute addresses.
__device__ __forceinline__ void align16(const uint8_t* buf, int64_t lo,
                                        int64_t hi, int64_t& lo16,
                                        int64_t& hi16) {
    const int64_t mis = static_cast<int64_t>(
        reinterpret_cast<uintptr_t>(buf) & 15);
    lo16 = lo - ((mis + lo) & 15);
    hi16 = hi + ((16 - ((mis + hi) & 15)) & 15);
}

// Where a tile's rows are read: reduced in shared memory, or (more than
// kRunCap rows) raw from the table, reduced at each read.
struct Rows {
    bool staged;
    const int4* table;
    int64_t base, buf_len;
};

__device__ __forceinline__ uint32_t out_off_at(const Rows& r,
                                               const uint4* s_row, int j) {
    return r.staged ? s_row[j].x
                    : static_cast<uint32_t>(__ldg(
                          reinterpret_cast<const int*>(r.table + j)));
}

__device__ __forceinline__ uint4 row_at(const Rows& r, const uint4* s_row,
                                        int j) {
    return r.staged ? s_row[j]
                    : reduce_row(__ldg(r.table + j), r.base, r.buf_len, 0,
                                 0, false);
}

// Value i of a reduced row, any case: past the row's limit, RLE, packed
// from the staged bytes or from device memory, cut at the payload end.
__device__ __forceinline__ uint32_t value_of(uint4 row, uint32_t i,
                                             bool staged,
                                             const uint32_t* pay,
                                             const uint8_t* buf) {
    const uint32_t k = i - row.x;
    const uint32_t bw = row.y >> 26;
    if (k >= (row.y & kCountMask)) return 0;
    if (bw == 0) return row.z;
    const uint32_t mask = (1u << bw) - 1u;
    if (staged) {
        const uint32_t bit = row.z + k * bw;
        const uint32_t w = bit >> 5;
        uint32_t x = __funnelshift_r(pay[w], pay[w + 1], bit & 31) & mask;
        const int left = static_cast<int>(row.w - bit);
        if (left < static_cast<int>(bw)) x &= (1u << left) - 1u;
        return x;
    }
    const uint64_t bit = uint64_t{k} * bw;
    const uint64_t b0 = row.z + (bit >> 3);
    uint32_t win = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (b0 + b < row.w) {
            win |= static_cast<uint32_t>(buf[b0 + b]) << (8 * b);
        }
    }
    return (win >> (bit & 7)) & mask;
}

__global__ void __launch_bounds__(kThreads, 6)
unpack_runs_kernel(const uint8_t* __restrict__ buf, uint32_t buf_len,
                   uint32_t base, const int4* __restrict__ table, int nrows,
                   uint32_t total, int32_t* __restrict__ out,
                   float rows_per_value, float bytes_per_value, int win) {
    __shared__ uint4 s_pay[kPayCap / 16 + 1];
    __shared__ uint4 s_row[kRunCap];
    __shared__ int s_r0;
    __shared__ uint32_t s_lo, s_hi;

    const int tid = threadIdx.x;
    const uint32_t t0 = blockIdx.x * static_cast<uint32_t>(kTile);
    const uint32_t t1 = min(t0 + static_cast<uint32_t>(kTile), total);

    // The tile's first row r0 (the last with out_off <= t0): guessed from
    // the mean row length and checked on a window of win rows around the
    // guess, kMargin rows before it and the rows a tile holds on average
    // after it; the window is also the first batch of rows staged.  A warp
    // search when the guess misses.
    if (tid == 0) {
        s_lo = 0xffffffffu;
        s_hi = 0;
    }
    const int w0 = max(static_cast<int>(t0 * rows_per_value) - kMargin, 0);
    int4 raw = make_int4(0x7fffffff, 0, 0, 0);
    if (tid < win && w0 + tid < nrows) raw = __ldg(table + w0 + tid);
    // While the rows load, copy in the bytes the tile most likely needs:
    // its share of the buffer in proportion to its values, kSlack bytes
    // wider on each side.  Right for a page of one run and for runs of
    // even length; when the rows show a wrong guess, the bytes they need
    // are copied after all.
    int64_t g_lo16, g_hi16;
    align16(buf,
            max64(base + static_cast<int64_t>(t0 * bytes_per_value) - kSlack,
                  0),
            min64(base + static_cast<int64_t>(t1 * bytes_per_value) + kSlack,
                  buf_len),
            g_lo16, g_hi16);
    const bool guessed = g_hi16 > g_lo16 && g_hi16 - g_lo16 <= kPayCap;
    if (guessed) {
        copy_span(buf, buf_len, g_lo16, static_cast<int>(g_hi16 - g_lo16) / 16,
                  s_pay, tid);
    }
    const int le = __syncthreads_count(static_cast<uint32_t>(raw.x) <= t0);
    const bool hit = le > 0 && (le < win || w0 + win >= nrows);
    int r0, nr = 0, first;
    if (hit) {
        r0 = w0 + le - 1;
        const bool in = w0 + tid >= r0 && static_cast<uint32_t>(raw.x) < t1;
        if (in) stage_row(raw, w0 + tid - r0, t0, t1, base, buf_len, s_row,
                          &s_lo, &s_hi);
        nr = __syncthreads_count(in);
        first = r0 + nr == w0 + win ? w0 + win : nrows;
    } else {
        if (tid < 32) {
            const int r = first_row(table, nrows, t0);
            if (tid == 0) s_r0 = r;
        }
        __syncthreads();
        r0 = first = s_r0;
    }
    // More rows that start before t1 (the rest of a prefix from r0).
    while (first < nrows) {
        const int r = first + tid;
        bool in = false;
        if (r < nrows) {
            const int4 row = __ldg(table + r);
            in = static_cast<uint32_t>(row.x) < t1;
            if (in) stage_row(row, r - r0, t0, t1, base, buf_len, s_row,
                              &s_lo, &s_hi);
        }
        const int c = __syncthreads_count(in);
        nr += c;
        first = c == kThreads ? first + kThreads : nrows;
    }

    const bool rows_staged = nr <= kRunCap;
    const int64_t lo = s_lo, hi = s_hi;
    int64_t lo16 = 0, hi16 = 0;
    if (hi > lo) align16(buf, lo, hi, lo16, hi16);
    // the staged bytes: the guessed span if it holds the needed one
    const bool reuse = guessed && lo16 >= g_lo16 && hi16 <= g_hi16;
    const bool staged = rows_staged && (reuse || hi16 - lo16 <= kPayCap);
    if (staged && !reuse) {
        wait_copies();
        copy_span(buf, buf_len, lo16, static_cast<int>(hi16 - lo16) / 16,
                  s_pay, tid);
    }
    if (reuse) {
        lo16 = g_lo16;
        hi16 = g_hi16;
    }
    const int64_t span = hi16 - lo16;
    if (rows_staged) {
        for (int j = tid; j < nr; j += kThreads) {
            const uint4 s = s_row[j];
            s_row[j] = reduce_row(make_int4(s.x, s.y, s.z, s.w), base,
                                  buf_len, lo16, span, staged);
        }
    }
    wait_copies();
    __syncthreads();

    const uint32_t* pay = reinterpret_cast<const uint32_t*>(s_pay);
    const Rows rows{rows_staged, table + r0, base, buf_len};
    int j = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
        const uint32_t i0 = t0 + g * (kGroup * kThreads) + kGroup * tid;
        if (i0 >= t1) break;
        // last row (at or after the previous group's) with out_off <= i0
        int jhi = nr - 1;
        while (j < jhi) {
            const int mid = (j + jhi + 1) >> 1;
            if (out_off_at(rows, s_row, mid) <= i0) {
                j = mid;
            } else {
                jhi = mid - 1;
            }
        }
        uint4 row = row_at(rows, s_row, j);
        uint32_t next =
            j + 1 < nr ? out_off_at(rows, s_row, j + 1) : 0xffffffffu;
        const uint32_t k0 = i0 - row.x;
        const uint32_t bw = row.y >> 26;
        uint32_t v[kGroup];
        if (staged && bw != 0 && i0 + kGroup <= t1 && i0 + kGroup <= next
            && k0 + kGroup <= (row.y & kCountMask)
            && row.z + (k0 + kGroup) * bw <= row.w) {
            // the group lies inside one packed row and its payload
            const uint32_t mask = (1u << bw) - 1u;
            uint32_t bit = row.z + k0 * bw;
#pragma unroll
            for (int q = 0; q < kGroup; ++q, bit += bw) {
                const uint32_t w = bit >> 5;
                v[q] = __funnelshift_r(pay[w], pay[w + 1], bit & 31) & mask;
            }
        } else {
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                const uint32_t i = i0 + q;
                v[q] = 0;
                if (i < t1) {
                    while (i >= next) {
                        ++j;
                        row = row_at(rows, s_row, j);
                        next = j + 1 < nr ? out_off_at(rows, s_row, j + 1)
                                          : 0xffffffffu;
                    }
                    v[q] = value_of(row, i, staged, pay, buf);
                }
            }
        }
        if (i0 + kGroup <= t1) {
            *reinterpret_cast<int4*>(out + i0) =
                make_int4(v[0], v[1], v[2], v[3]);
        } else {
            for (int q = 0; q < kGroup && i0 + q < t1; ++q) {
                out[i0 + q] = static_cast<int32_t>(v[q]);
            }
        }
    }
}

}  // namespace

extern "C" int unpack_runs_tile() { return kTile; }

extern "C" int unpack_runs_launch(const void* buf, int64_t buf_len,
                                  int64_t base, const void* table,
                                  int64_t nrows, int64_t total, void* out,
                                  void* stream) {
    if (total <= 0 || nrows <= 0) return 0;
    const int64_t blocks = (total + kTile - 1) / kTile;
    // the guesses' scales, and the window's length (see the kernel)
    const int64_t expect = (kTile * nrows + total - 1) / total;
    const int64_t win = (expect + 2 * kMargin + 31) & ~int64_t{31};
    unpack_runs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<uint32_t>(buf_len),
        static_cast<uint32_t>(base), static_cast<const int4*>(table),
        static_cast<int>(nrows), static_cast<uint32_t>(total),
        static_cast<int32_t*>(out),
        static_cast<float>(static_cast<double>(nrows) / total),
        static_cast<float>(static_cast<double>(buf_len - base) / total),
        static_cast<int>(win < kThreads ? win : kThreads));
    return static_cast<int>(cudaGetLastError());
}
