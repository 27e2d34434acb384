// K1: Parquet RLE / bit-packed hybrid run expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/pallas/decode.py::_unpack_body
// (launched by _unpack_call once per bit-packed run, with one jnp.full per
// RLE run and a concatenate).  This kernel expands a whole page's run table
// in one launch: the host parses the run headers
// (io/parquet_native.py::split_hybrid_runs) and uploads them as int64
// arrays; the payload bytes stay where they are in device memory.
//
// One thread makes one output value:
//   * binary search over out_off finds the value's run;
//   * an RLE run writes its repeated value;
//   * a packed run reads the <= 4-byte little-endian window at byte
//     (k*bw)/8 of the run's payload, shifts right by (k*bw)%8 and masks to
//     bw bits.  Bytes past the run's payload (or the buffer) read as 0, as
//     the reference zero-pads the payload to whole groups;
//   * values past the last run's end are 0.
// bw <= 24, so a window of 4 bytes holds every value (bw + 7 <= 31 bits)
// and the uint32 result fits int32 unchanged.
//
// Bound on this card: memory.  It reads the packed payload and the run
// table once and writes 4 bytes per value, and does a handful of integer
// operations per value, far below the H100's rate.  Least time =
// (payload bytes + 48 * runs + 4 * total) / 3.35 TB/s.  The design keeps
// the simple form (byte loads through L1, no shared-memory staging or
// vector loads): neighbouring threads read neighbouring bytes, so each
// 32-byte sector is fetched from memory once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void unpack_runs_kernel(const uint8_t* __restrict__ buf,
                                   int64_t buf_len, int64_t base,
                                   const int64_t* __restrict__ out_off,
                                   const int64_t* __restrict__ count,
                                   const int64_t* __restrict__ is_packed,
                                   const int64_t* __restrict__ byte_off,
                                   const int64_t* __restrict__ nbytes,
                                   const int64_t* __restrict__ value,
                                   int64_t nruns, int bw, int64_t total,
                                   int32_t* __restrict__ out) {
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    // last run r with out_off[r] <= i (out_off[0] == 0, ascending)
    int64_t lo = 0, hi = nruns - 1;
    while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (out_off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const int64_t r = lo;
    const int64_t k = i - out_off[r];
    uint32_t v = 0;
    if (k < count[r]) {
        if (!is_packed[r]) {
            v = static_cast<uint32_t>(value[r]);
        } else {
            const int64_t bit = k * bw;
            const int64_t start = base + byte_off[r];
            int64_t end = start + nbytes[r];
            if (end > buf_len) end = buf_len;
            const int64_t b0 = start + (bit >> 3);
            uint32_t win = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t p = b0 + j;
                if (p < end) win |= static_cast<uint32_t>(buf[p]) << (8 * j);
            }
            v = (win >> (bit & 7)) & ((1u << bw) - 1u);
        }
    }
    out[i] = static_cast<int32_t>(v);
}

}  // namespace

extern "C" int unpack_runs_launch(const void* buf, int64_t buf_len,
                                  int64_t base, const void* out_off,
                                  const void* count, const void* is_packed,
                                  const void* byte_off, const void* nbytes,
                                  const void* value, int64_t nruns, int bw,
                                  int64_t total, void* out, void* stream) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    unpack_runs_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), buf_len, base,
        static_cast<const int64_t*>(out_off),
        static_cast<const int64_t*>(count),
        static_cast<const int64_t*>(is_packed),
        static_cast<const int64_t*>(byte_off),
        static_cast<const int64_t*>(nbytes),
        static_cast<const int64_t*>(value), nruns, bw, total,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
