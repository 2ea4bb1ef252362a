// Fused record binning + per-frame adaptive log-odds chain for one window
// of the brick map, written for Hopper (sm_90a).
//
// Replaces: sonar_3d_reconstruction_tpu/pallas/bin_kernel.py::_bin_kernel
// (the TPU kernel behind pallas_bin_apply, non-stats_out form).
//
// What it computes.  The window's unique records arrive sorted by
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
// and writes the new row plus a touched-this-window mask.
//
// Design.  The TPU kernel bins with one-hot MXU matmuls because the TPU
// has no cheap indexed writes.  Hopper does: one block per brick,
// blockDim = vol, a shared (B, vol) payload table zeroed per block.
// Records are unique per (brick, frame, offset) slot, so threads store
// their payloads with plain shared-memory writes (no atomics).  After one
// barrier, thread v walks frames 0..B-1 on voxel v in registers, which
// keeps the frame order the adaptive update needs (it reads the
// pre-frame value).
//
// What bounds it.  Per window it reads L records (2 x int64 = 16 bytes
// each) and NB+1 starts, reads and writes NB*vol values and writes NB*vol
// touched bytes: about L*16 + NB*vol*(2*sizeof(T) + 1) bytes.  There is no
// matrix work and a few flops per record, so it is bound by memory traffic
// and launch latency, not by arithmetic; no tensor cores are involved.
//
// Rounding.  Build with --fmad=false and without fast math: every
// product and sum rounds on its own, exp is the full-precision expf/exp,
// and the division is IEEE, as in the separate PyTorch operations of the
// plain version (kernels/bin_apply.py::bin_apply_reference), so the two
// agree bit for bit in float32 and float64.

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

template <typename T>
__global__ void bin_apply_kernel(
    const int64_t* __restrict__ s_flat,
    const int64_t* __restrict__ s_pay,
    const int64_t* __restrict__ starts,
    const T* __restrict__ rows,
    T* __restrict__ v_out,
    bool* __restrict__ upd_out,
    int B, int vol, int f_bits, int o,
    ChainConsts<T> c) {
  extern __shared__ uint32_t pay[];  // (B, vol) payloads of this brick
  const int64_t brick = blockIdx.x;
  const int tid = threadIdx.x;

  for (int k = tid; k < B * vol; k += blockDim.x) pay[k] = 0u;
  __syncthreads();

  const int64_t begin = starts[brick];
  const int64_t end = starts[brick + 1];
  const uint32_t fmask = (1u << f_bits) - 1u;
  const uint32_t omask = (1u << o) - 1u;
  for (int64_t g = begin + tid; g < end; g += blockDim.x) {
    const uint32_t key = static_cast<uint32_t>(s_flat[g]);
    const uint32_t frame = (key >> o) & fmask;
    if (frame < static_cast<uint32_t>(B)) {
      pay[frame * vol + (key & omask)] = static_cast<uint32_t>(s_pay[g]);
    }
  }
  __syncthreads();

  const int64_t idx = brick * vol + tid;
  T v = rows[idx];
  bool upd = false;
  for (int f = 0; f < B; ++f) {
    const uint32_t d = pay[f * vol + tid];
    const T cnt = static_cast<T>(d >> 16);
    const T occ = static_cast<T>(d & 0xFFFFu);
    const T lo_sum = occ * c.occ_l + (cnt - occ) * c.free_l;
    upd = upd || (d != 0u);
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
  }
  v_out[idx] = v;
  upd_out[idx] = upd;
}

template <typename T>
int launch(const void* s_flat, const void* s_pay, const void* starts,
           const void* rows, void* v_out, void* upd_out, int nb, int B,
           int vol, int f_bits, int o, ChainConsts<T> c, void* stream) {
  const size_t smem = static_cast<size_t>(B) * vol * sizeof(uint32_t);
  bin_apply_kernel<T><<<nb, vol, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s_flat), static_cast<const int64_t*>(s_pay),
      static_cast<const int64_t*>(starts), static_cast<const T*>(rows),
      static_cast<T*>(v_out), static_cast<bool*>(upd_out), B, vol, f_bits, o,
      c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int bin_apply_f32(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, int nb, int B, int vol, int f_bits,
                             int o, float occ_l, float free_l, int adaptive,
                             float thr, float ratio, float lo_min,
                             float lo_max, void* stream) {
  ChainConsts<float> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<float>(s_flat, s_pay, starts, rows, v_out, upd_out, nb, B,
                       vol, f_bits, o, c, stream);
}

extern "C" int bin_apply_f64(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, int nb, int B, int vol, int f_bits,
                             int o, double occ_l, double free_l, int adaptive,
                             double thr, double ratio, double lo_min,
                             double lo_max, void* stream) {
  ChainConsts<double> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<double>(s_flat, s_pay, starts, rows, v_out, upd_out, nb, B,
                        vol, f_bits, o, c, stream);
}
