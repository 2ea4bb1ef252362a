// Fused record binning + per-frame adaptive log-odds chain for one window
// of the brick map, written for Hopper (sm_90a).
//
// Replaces: sonar_3d_reconstruction_tpu/pallas/bin_kernel.py::_bin_kernel
// (the TPU kernel behind pallas_bin_apply), in both its forms: unique
// records (bin_apply_f32/_f64) and raw candidates with per-frame unique
// counts (stats_out=True; bin_apply_raw_f32/_f64).
//
// What it computes.  The window's records arrive sorted by
// (brick, frame, offset); compacted brick i owns records
// [starts[i], starts[i+1]).  Each record carries its slot in the key's low
// bits (frame = (key >> o) & (2^f_bits - 1), offset = key & (2^o - 1)) and
// the payload count << 16 | n_occ.  For every brick the kernel bins the
// payloads into a (B, vol) table, then runs the reference's sequential
// per-frame update over the brick's value row, frame 0 first:
//   lo_sum = n_occ * L_occ + (count - n_occ) * L_free
//   avg    = lo_sum / max(count, 1)
//   p      = 1 / (1 + exp(-v));  scale = p <= thr ? (p / thr) * ratio : 1
//   v      = count > 0 ? clamp(v + (occ > 0 && avg > 0 ? avg * scale : avg),
//                              lo_min, lo_max) : v
// and writes the new row plus a touched-this-window mask (count != 0 in
// some frame).  The raw form also counts, per frame and over all bricks,
// the voxels with n_occ > 0 (occupied) and those with count != 0 and
// n_occ == 0 (free): the reference's per-frame unique-voxel stats.
//
// Design.  The TPU kernel bins with one-hot MXU matmuls because the TPU
// has no cheap indexed writes.  Hopper does: one block per brick,
// blockDim = vol, (B, vol) tables in shared memory zeroed per block.
//   * Unique records (at most one per slot) are stored with plain shared
//     writes into one payload table.
//   * Raw candidates repeat slots, so count and n_occ are summed with
//     shared-memory atomicAdd into two separate u32 tables (summing the
//     packed payload would carry n_occ into the count field).  Integer
//     sums are exact and order-free, so the result does not depend on the
//     order of the records or of the atomics.  The strided loop takes a
//     range of any length; a hot brick's range costs its length over
//     blockDim iterations.
// After one barrier, thread v walks frames 0..B-1 on voxel v in
// registers, which keeps the frame order the adaptive update needs (it
// reads the pre-frame value).  The raw form reduces each frame's flags
// with a warp ballot + popcount into shared per-frame counters, and the
// block adds its nonzero counters to the (B,) outputs with 64-bit integer
// atomics (deterministic: integer addition is associative).
//
// Bounds.  The tables are u32: a slot's summed count and n_occ must stay
// below 2^32.  They are converted with static_cast<T>, exact below 2^24
// in float32 (and 2^53 in float64); above that both the kernel and the
// plain version round to nearest, so they still agree.  A raw candidate
// carries count 1, so a slot's sum is its number of candidates in one
// frame, far below 2^24 for any ping (a full 500x512 fan holds ~2^18).
//
// What bounds it.  Per window it reads L records (2 x int64 = 16 bytes
// each) and NB+1 starts, reads and writes NB*vol values and writes NB*vol
// touched bytes: about L*16 + NB*vol*(2*sizeof(T) + 1) bytes.  There is no
// matrix work and a few flops per record, so it is bound by memory traffic
// and launch latency, not by arithmetic; no tensor cores are involved.
// In the raw form a brick with many candidates also serialises on its
// shared-memory atomics.
//
// Rounding.  Build with --fmad=false and without fast math: every
// product and sum rounds on its own, exp is the full-precision expf/exp,
// and the division is IEEE, as in the separate PyTorch operations of the
// plain versions (kernels/bin_apply.py), so the two agree bit for bit in
// float32 and float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
struct ChainConsts {
  T occ_l, free_l, thr, ratio, lo_min, lo_max;
  int adaptive;
};

template <typename T, bool RAW>
__global__ void bin_apply_kernel(
    const int64_t* __restrict__ s_flat,
    const int64_t* __restrict__ s_pay,
    const int64_t* __restrict__ starts,
    const T* __restrict__ rows,
    T* __restrict__ v_out,
    bool* __restrict__ upd_out,
    unsigned long long* __restrict__ occ_u,   // (B,) RAW only
    unsigned long long* __restrict__ free_u,  // (B,) RAW only
    int B, int vol, int f_bits, int o,
    ChainConsts<T> c) {
  // unique: pay (B, vol).  RAW: cnt (B, vol), occ (B, vol), then the
  // per-frame occupied and free counters (B each)
  extern __shared__ uint32_t smem[];
  const int table = B * vol;
  uint32_t* cnt_s = smem;
  uint32_t* occ_s = smem + table;
  uint32_t* stat_s = smem + 2 * table;
  const int64_t brick = blockIdx.x;
  const int tid = threadIdx.x;

  const int n_zero = RAW ? 2 * table + 2 * B : table;
  for (int k = tid; k < n_zero; k += blockDim.x) smem[k] = 0u;
  __syncthreads();

  const int64_t begin = starts[brick];
  const int64_t end = starts[brick + 1];
  const uint32_t fmask = (1u << f_bits) - 1u;
  const uint32_t omask = (1u << o) - 1u;
  for (int64_t g = begin + tid; g < end; g += blockDim.x) {
    const uint32_t key = static_cast<uint32_t>(s_flat[g]);
    const uint32_t frame = (key >> o) & fmask;
    if (frame < static_cast<uint32_t>(B)) {
      const uint32_t pay = static_cast<uint32_t>(s_pay[g]);
      const uint32_t slot = frame * vol + (key & omask);
      if (RAW) {
        atomicAdd(&cnt_s[slot], pay >> 16);
        atomicAdd(&occ_s[slot], pay & 0xFFFFu);
      } else {
        cnt_s[slot] = pay;
      }
    }
  }
  __syncthreads();

  // lanes of this thread's warp that exist (vol may be below 32)
  const int warp_base = tid & ~31;
  const int warp_n = min(32, static_cast<int>(blockDim.x) - warp_base);
  const unsigned lanes = warp_n == 32 ? 0xFFFFFFFFu : (1u << warp_n) - 1u;

  const int64_t idx = brick * vol + tid;
  T v = rows[idx];
  bool upd = false;
  for (int f = 0; f < B; ++f) {
    uint32_t cnt_i, occ_i;
    if (RAW) {
      cnt_i = cnt_s[f * vol + tid];
      occ_i = occ_s[f * vol + tid];
    } else {
      const uint32_t d = cnt_s[f * vol + tid];
      cnt_i = d >> 16;
      occ_i = d & 0xFFFFu;
    }
    const T cnt = static_cast<T>(cnt_i);
    const T occ = static_cast<T>(occ_i);
    const T lo_sum = occ * c.occ_l + (cnt - occ) * c.free_l;
    upd = upd || (cnt_i != 0u);
    const T one = static_cast<T>(1);
    const T avg = lo_sum / (cnt > one ? cnt : one);
    T update = avg;
    if (c.adaptive) {
      const T p = one / (one + exp_t(-v));
      const T scale = p <= c.thr ? (p / c.thr) * c.ratio : one;
      update = (occ > static_cast<T>(0) && avg > static_cast<T>(0))
                   ? avg * scale : avg;
    }
    T nv = v + update;
    nv = nv > c.lo_min ? nv : c.lo_min;
    nv = nv < c.lo_max ? nv : c.lo_max;
    v = cnt > static_cast<T>(0) ? nv : v;
    if (RAW) {
      const unsigned n_occ = __popc(__ballot_sync(lanes, occ_i != 0u));
      const unsigned n_free =
          __popc(__ballot_sync(lanes, cnt_i != 0u && occ_i == 0u));
      if (tid == warp_base) {
        if (n_occ) atomicAdd(&stat_s[f], n_occ);
        if (n_free) atomicAdd(&stat_s[B + f], n_free);
      }
    }
  }
  v_out[idx] = v;
  upd_out[idx] = upd;

  if (RAW) {
    __syncthreads();
    for (int k = tid; k < B; k += blockDim.x) {
      if (stat_s[k]) {
        atomicAdd(&occ_u[k], static_cast<unsigned long long>(stat_s[k]));
      }
      if (stat_s[B + k]) {
        atomicAdd(&free_u[k], static_cast<unsigned long long>(stat_s[B + k]));
      }
    }
  }
}

template <typename T, bool RAW>
int launch(const void* s_flat, const void* s_pay, const void* starts,
           const void* rows, void* v_out, void* upd_out, void* occ_u,
           void* free_u, int nb, int B, int vol, int f_bits, int o,
           ChainConsts<T> c, void* stream) {
  const size_t words = RAW ? 2 * static_cast<size_t>(B) * vol + 2 * B
                           : static_cast<size_t>(B) * vol;
  bin_apply_kernel<T, RAW>
      <<<nb, vol, words * sizeof(uint32_t),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(s_flat),
          static_cast<const int64_t*>(s_pay),
          static_cast<const int64_t*>(starts), static_cast<const T*>(rows),
          static_cast<T*>(v_out), static_cast<bool*>(upd_out),
          static_cast<unsigned long long*>(occ_u),
          static_cast<unsigned long long*>(free_u), B, vol, f_bits, o, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
// The raw forms ADD their per-frame counts into occ_u / free_u, (B,)
// int64 buffers the caller zeroes.
extern "C" int bin_apply_f32(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, int nb, int B, int vol, int f_bits,
                             int o, float occ_l, float free_l, int adaptive,
                             float thr, float ratio, float lo_min,
                             float lo_max, void* stream) {
  ChainConsts<float> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<float, false>(s_flat, s_pay, starts, rows, v_out, upd_out,
                              nullptr, nullptr, nb, B, vol, f_bits, o, c,
                              stream);
}

extern "C" int bin_apply_f64(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, int nb, int B, int vol, int f_bits,
                             int o, double occ_l, double free_l, int adaptive,
                             double thr, double ratio, double lo_min,
                             double lo_max, void* stream) {
  ChainConsts<double> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<double, false>(s_flat, s_pay, starts, rows, v_out, upd_out,
                               nullptr, nullptr, nb, B, vol, f_bits, o, c,
                               stream);
}

extern "C" int bin_apply_raw_f32(const void* s_flat, const void* s_pay,
                                 const void* starts, const void* rows,
                                 void* v_out, void* upd_out, void* occ_u,
                                 void* free_u, int nb, int B, int vol,
                                 int f_bits, int o, float occ_l, float free_l,
                                 int adaptive, float thr, float ratio,
                                 float lo_min, float lo_max, void* stream) {
  ChainConsts<float> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<float, true>(s_flat, s_pay, starts, rows, v_out, upd_out,
                             occ_u, free_u, nb, B, vol, f_bits, o, c, stream);
}

extern "C" int bin_apply_raw_f64(const void* s_flat, const void* s_pay,
                                 const void* starts, const void* rows,
                                 void* v_out, void* upd_out, void* occ_u,
                                 void* free_u, int nb, int B, int vol,
                                 int f_bits, int o, double occ_l,
                                 double free_l, int adaptive, double thr,
                                 double ratio, double lo_min, double lo_max,
                                 void* stream) {
  ChainConsts<double> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<double, true>(s_flat, s_pay, starts, rows, v_out, upd_out,
                              occ_u, free_u, nb, B, vol, f_bits, o, c,
                              stream);
}
