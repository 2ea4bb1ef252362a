// Bucketed key-table find-or-insert + value accumulate, written for Hopper
// (sm_90a).
//
// Replaces: sonar_3d_reconstruction_tpu/pallas/table_kernel.py::_kernel
// (the TPU kernel behind pallas_lookup_accumulate).
//
// What it computes.  The table has NB buckets of 128 slots; row b of the
// (NB, 256) key table holds bucket b's 128 hi words then its 128 lo words
// (u32 values in int64, EMPTY = 0xFFFFFFFF), and row b of the (NB, 128)
// float32 value table its values.  Buckets fill left to right, so a
// bucket's first empty slot is its fill count.  Records are processed in
// order; record (hi, lo, upd) with bucket = mix2(hi, lo) & (NB - 1):
//   * if (hi, lo) is in the bucket, upd is added to its value;
//   * else, if the bucket has an empty slot, the key is written at the
//     fill count and upd is added to that slot's value;
//   * else the record is dropped.
//
// Design.  The TPU kernel walks all records in one sequential scalar loop
// with the whole table in VMEM.  A record only ever touches its own
// bucket, so sequential semantics hold per bucket, and buckets are
// independent.  The wrapper (kernels/lookup_accumulate.py) groups the
// active records by bucket with a STABLE sort, which keeps record order
// within a bucket, and passes the permutation and each bucket's segment
// [seg[b], seg[b+1]).  Here one warp owns one bucket: it loads the
// bucket's 128 hi words, 128 lo words and 128 values into registers, 4
// per lane (slot s sits in lane s % 32, register s / 32), so a find is 4
// ballots and no shared memory is needed.  The warp then walks its
// segment in order, 32 records at a time (each lane loads one record, the
// warp broadcasts them with shuffles): a ballot finds a match, otherwise
// the fill count names the insert slot, and the owning lane adds upd.
// The warp writes the row back once.  Buckets without records are copied
// through, so the kernel writes complete new tables and leaves its inputs
// untouched, like the JAX function.  Duplicate keys within one call find
// the earlier record's slot, as in the sequential TPU kernel.
//
// What bounds it.  Every launch reads and writes both tables whole
// (NB * (256 * 8 + 128 * 4) bytes each way) plus 24 bytes per record, so
// at table sizes of a few MB and more it is bound by memory traffic; the
// in-order walk of a bucket's records is a dependent chain of a few
// dozen shuffles and compares per record, short while buckets hold tens
// of records.
//
// Rounding.  One float32 addition per record, as in the plain version and
// the TPU kernel, in the same order within a slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 128;
constexpr int kPerLane = kSlots / 32;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 4;

__global__ void lookup_accumulate_kernel(
    const int64_t* __restrict__ khi,       // (U,) record key words
    const int64_t* __restrict__ klo,
    const float* __restrict__ upd,         // (U,)
    const int64_t* __restrict__ order,     // active records grouped by bucket
    const int64_t* __restrict__ seg,       // (NB+1,) bucket segments of order
    const int64_t* __restrict__ rows_in,   // (NB, 256)
    const float* __restrict__ vals_in,     // (NB, 128)
    int64_t* __restrict__ rows_out,
    float* __restrict__ vals_out,
    int nb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= nb) return;

  const int64_t* row = rows_in + b * (2 * kSlots);
  uint32_t hi[kPerLane], lo[kPerLane];
  float val[kPerLane];
  int n_empty = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = j * 32 + lane;
    hi[j] = static_cast<uint32_t>(row[s]);
    lo[j] = static_cast<uint32_t>(row[kSlots + s]);
    val[j] = vals_in[b * kSlots + s];
    n_empty += __popc(__ballot_sync(0xFFFFFFFFu, hi[j] == kEmpty));
  }
  // prefix fill: the first empty slot is the number of occupied ones
  int fill = kSlots - n_empty;

  const int64_t r0 = seg[b];
  const int64_t r1 = seg[b + 1];
  for (int64_t base = r0; base < r1; base += 32) {
    const int64_t left = r1 - base;
    const int n = left < 32 ? static_cast<int>(left) : 32;
    uint32_t my_hi = 0u, my_lo = 0u;
    float my_upd = 0.0f;
    if (lane < n) {
      const int64_t i = order[base + lane];
      my_hi = static_cast<uint32_t>(khi[i]);
      my_lo = static_cast<uint32_t>(klo[i]);
      my_upd = upd[i];
    }
    for (int k = 0; k < n; ++k) {
      const uint32_t rh = __shfl_sync(0xFFFFFFFFu, my_hi, k);
      const uint32_t rl = __shfl_sync(0xFFFFFFFFu, my_lo, k);
      const float ru = __shfl_sync(0xFFFFFFFFu, my_upd, k);
      int slot = kSlots;
#pragma unroll
      for (int j = kPerLane - 1; j >= 0; --j) {
        // the lowest matching slot, as the TPU kernel's masked min
        const unsigned m =
            __ballot_sync(0xFFFFFFFFu, hi[j] == rh && lo[j] == rl);
        if (m) slot = j * 32 + __ffs(m) - 1;
      }
      if (slot == kSlots) {
        if (fill == kSlots) continue;  // full bucket: the record is dropped
        slot = fill++;
        if ((slot & 31) == lane) {
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            if (j == (slot >> 5)) {
              hi[j] = rh;
              lo[j] = rl;
            }
          }
        }
      }
      if ((slot & 31) == lane) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          if (j == (slot >> 5)) val[j] = val[j] + ru;
        }
      }
    }
  }

  int64_t* out = rows_out + b * (2 * kSlots);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = j * 32 + lane;
    out[s] = static_cast<int64_t>(hi[j]);
    out[kSlots + s] = static_cast<int64_t>(lo[j]);
    vals_out[b * kSlots + s] = val[j];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int lookup_accumulate(const void* khi, const void* klo,
                                 const void* upd, const void* order,
                                 const void* seg, const void* rows_in,
                                 const void* vals_in, void* rows_out,
                                 void* vals_out, int nb, void* stream) {
  const int blocks = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lookup_accumulate_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(khi), static_cast<const int64_t*>(klo),
      static_cast<const float*>(upd), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(seg), static_cast<const int64_t*>(rows_in),
      static_cast<const float*>(vals_in), static_cast<int64_t*>(rows_out),
      static_cast<float*>(vals_out), nb);
  return static_cast<int>(cudaGetLastError());
}
