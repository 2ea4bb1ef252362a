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
// has no cheap indexed writes; Hopper has shared-memory stores and
// atomics.  One block takes a tile of TB consecutive compacted bricks,
// blockDim = TB * vol (the wrapper picks TB = 2 at vol = 64,
// kernels/bin_apply.py).
//   * Tiles.  The records of consecutive bricks are contiguous, so a tile
//     reads the one range [starts[j*TB], starts[min((j+1)*TB, NB)]), kRecs
//     adjacent records per thread per step.  A record's brick within the
//     tile is its position against the tile's TB+1 starts, held in shared
//     memory (as bin_kernel.py ranks them): brick ids in the key are box
//     ids, not ranks.  A hot brick's records spread over all of the tile's
//     threads.
//   * Frame masks.  Binning also sets a per-voxel bit mask of the frames
//     that received a record (shared atomicOr, ceil(B/32) words a voxel).
//     After the barrier each thread steps its voxel only through its own
//     masked frames, in ascending order.  A step of a slot that holds no
//     record (count 0, n_occ 0) leaves v, the touched bit and both counts
//     as they were, so skipping it is exact; a warp takes as many steps as
//     its busiest lane.  A thread reads only table entries its mask says
//     were written, so the unique form's table needs no zeroing.  The exp
//     and the two divisions of the adaptive scale run only where n_occ > 0
//     and avg > 0, the only slots that use them.
//   * Unique records (at most one per slot) are stored with plain shared
//     writes into one payload table.
//   * Raw candidates repeat slots.  Count and n_occ are summed with shared
//     atomicAdd into two separate u32 tables (summing the packed payload
//     would carry n_occ into the count field); a thread first sums each
//     run of equal slots among its kRecs records (the sort puts duplicates
//     next to each other) and adds it with one set of atomics.  Integer
//     sums are exact and order-free, so the atomics' order does not
//     matter.  Each stepping thread counts its voxel's frame as occupied
//     (n_occ > 0) or free (count != 0) with a shared atomicAdd, and the
//     block adds its nonzero counters to the (B,) outputs with 64-bit
//     integer atomics (deterministic: integer addition is associative).
//
// Bounds.  The tables are u32: a slot's summed count and n_occ must stay
// below 2^32.  They are converted with static_cast<T>, exact below 2^24
// in float32 (and 2^53 in float64); above that both the kernel and the
// plain version round to nearest, so they still agree.  A raw candidate
// carries count 1, so a slot's sum is its number of candidates in one
// frame, far below 2^24 for any ping (a full 500x512 fan holds ~2^18).
//
// What bounds it.  Per window it must read L records (2 x int64 = 16 bytes
// each), NB+1 starts and NB*vol values, and write NB*vol values and NB*vol
// touched bytes: about L*16 + NB*vol*(2*sizeof(T) + 1) bytes.  There is
// no matrix work and no tensor cores are involved.  Measured on an H100
// (scripts/torch_k1_bench.py; numbers and runs in PERF.md) at the main
// path's widest real windows, float32: the unique form at 46-47 % and
// the raw form at 48-50 % of that memory bound, 2x and 1.8x faster than
// one block per brick stepping every frame.  Half of each record's 16
// bytes are zero high words: against the bound of u32 records (L*8 bytes,
// as the TPU kernel reads them) both forms are at about a quarter, and
// such streams, from the window sort on, are the next step.  In the
// unique form the frame chain takes more than half of the time (binning
// and the fixed costs alone take 6.4 of 15 us).  Measured and left out,
// because they gained
// nothing or lost: summing raw runs across a warp (warp prefix sums, or
// __reduce_add_sync over run masks); 16-byte record loads; loading a
// thread's next records, or the value rows, ahead of time; a persistent
// grid that loads a tile while the previous tile's chain runs (a window
// is ~1.5 waves of blocks, and hot bricks unbalance a fixed tile order);
// sorting a tile's voxels by their number of frames (28 % fewer warp
// steps, eaten by its barriers); overlapping a step with the next frame's
// table read and average; warp-wide frame masks (52 % of the warp-frames
// stepped on real windows, against 32 % for per-thread masks); 1, 4 or 8
// records per thread.  A zero dividend sends the IEEE division down its
// slow path; a voxel steps with count 0 only for a record of count 0,
// which the main path does not make.
//
// Rounding.  Build with --fmad=false and without fast math: every
// product and sum rounds on its own, exp is the full-precision expf/exp,
// and the division is IEEE, as in the separate PyTorch operations of the
// plain versions (kernels/bin_apply.py), so the two agree bit for bit in
// float32 and float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // TB * vol, kernels/bin_apply.py
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
struct ChainConsts {
  T occ_l, free_l, thr, ratio, lo_min, lo_max;
  int adaptive;
};

// Shared-memory layout of a block, in bytes from the start: its tile's
// TB+1 starts (int64, padded to 16 bytes), the frame masks
// (nw x TB*vol u32), then the tables: the payload table (TB, B, vol) u32,
// or for RAW the count and n_occ tables and the 2*B per-frame counters.
__host__ __device__ inline size_t starts_bytes(int tb) {
  return (static_cast<size_t>(tb + 1) * sizeof(int64_t) + 15) & ~size_t{15};
}

__host__ __device__ inline size_t smem_bytes(bool raw, int tb, int B,
                                             int vol) {
  const size_t nw = (B + 31) / 32;
  const size_t table = static_cast<size_t>(tb) * B * vol;
  const size_t words = nw * tb * vol + (raw ? 2 * table + 2 * B : table);
  return starts_bytes(tb) + words * sizeof(uint32_t);
}

// Adjacent records a thread bins in one step: a raw thread adds a run of
// equal slots among them with one set of atomics.
constexpr int kRecs = 2;

// The low words of records kRecs*p .. kRecs*p + kRecs-1 (zeros past the
// arrays).  Keys and payloads are u32 values held in int64.
struct Group {
  uint32_t key[kRecs], pay[kRecs];
};

__device__ __forceinline__ Group load_group(const int64_t* __restrict__ s_flat,
                                            const int64_t* __restrict__ s_pay,
                                            int64_t p, long long n_rec) {
  Group out;
  for (int h = 0; h < kRecs; ++h) {
    const int64_t g = kRecs * p + h;
    out.key[h] = g < n_rec ? static_cast<uint32_t>(s_flat[g]) : 0u;
    out.pay[h] = g < n_rec ? static_cast<uint32_t>(s_pay[g]) : 0u;
  }
  return out;
}

__device__ __forceinline__ void zero_words(uint32_t* w, int n) {
  uint4* w4 = reinterpret_cast<uint4*>(w);
  for (int k = threadIdx.x; k < n / 4; k += blockDim.x) {
    w4[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int k = (n & ~3) + threadIdx.x; k < n; k += blockDim.x) w[k] = 0u;
}

// The tile being binned: its starts in shared memory (st[0..nt]), its
// number of bricks and its record range [st[0], st[nt]).
struct TileView {
  const int64_t* st;
  int nt;
  int64_t r0, r1;
};

// Bins records kRecs*p .. kRecs*p + kRecs-1 into the tile's tables and
// frame masks.
template <bool RAW>
__device__ __forceinline__ void bin_group(const Group& gr, int64_t p,
                                          const TileView& t, int B, int vol,
                                          int o, uint32_t fmask, int tvol,
                                          uint32_t* mask_s, uint32_t* cnt_s,
                                          uint32_t* occ_s) {
  const int64_t g = kRecs * p;
  // the tile-local brick of each record: how many of the tile's later
  // starts it has reached
  int rank[kRecs] = {};
  for (int k = 1; k < t.nt; ++k) {
    const int64_t s = t.st[k];
    for (int h = 0; h < kRecs; ++h) rank[h] += g + h >= s;
  }
  bool valid[kRecs];
  uint32_t slot[kRecs], mword[kRecs], bit[kRecs];
  for (int h = 0; h < kRecs; ++h) {
    const uint32_t frame = (gr.key[h] >> o) & fmask;
    const uint32_t off = gr.key[h] & static_cast<uint32_t>(vol - 1);
    valid[h] = g + h >= t.r0 && g + h < t.r1 &&
               frame < static_cast<uint32_t>(B);
    slot[h] = (rank[h] * B + frame) * vol + off;
    mword[h] = (frame >> 5) * tvol + rank[h] * vol + off;
    bit[h] = 1u << (frame & 31);
  }
  if (RAW) {
    // sums over each run of equal slots (the sort puts duplicates next to
    // each other), added at the run's last record
    uint32_t cn = 0u, oc = 0u;
    for (int h = 0; h < kRecs; ++h) {
      if (!valid[h]) continue;
      cn += gr.pay[h] >> 16;
      oc += gr.pay[h] & 0xFFFFu;
      if (h + 1 < kRecs && valid[h + 1] && slot[h + 1] == slot[h]) continue;
      if (cn) atomicAdd(&cnt_s[slot[h]], cn);
      if (oc) atomicAdd(&occ_s[slot[h]], oc);
      atomicOr(&mask_s[mword[h]], bit[h]);
      cn = oc = 0u;
    }
  } else {
    for (int h = 0; h < kRecs; ++h) {
      if (valid[h]) {
        cnt_s[slot[h]] = gr.pay[h];
        atomicOr(&mask_s[mword[h]], bit[h]);
      }
    }
  }
}

// The frame chain of one voxel (brick b of the tile, offset off; global
// row element idx) over the frames its own mask holds, lowest first.
template <typename T, bool RAW>
__device__ __forceinline__ void chain(const T* __restrict__ rows,
                                      T* __restrict__ v_out,
                                      bool* __restrict__ upd_out,
                                      int64_t idx, int b, int off,
                                      const uint32_t* mask_s,
                                      const uint32_t* cnt_s,
                                      const uint32_t* occ_s,
                                      uint32_t* stat_s, int nw, int tvol,
                                      int B, int vol, const ChainConsts<T>& c) {
  const T one = static_cast<T>(1);
  const T zero = static_cast<T>(0);
  T v = rows[idx];
  bool upd = false;
  for (int w = 0; w < nw; ++w) {
    for (uint32_t m = mask_s[w * tvol + threadIdx.x]; m; m &= m - 1u) {
      const int f = w * 32 + __ffs(m) - 1;
      const int s = (b * B + f) * vol + off;
      uint32_t cnt_i, occ_i;
      if (RAW) {
        cnt_i = cnt_s[s];
        occ_i = occ_s[s];
      } else {
        const uint32_t pay = cnt_s[s];
        cnt_i = pay >> 16;
        occ_i = pay & 0xFFFFu;
      }
      const T cnt = static_cast<T>(cnt_i);
      const T occ = static_cast<T>(occ_i);
      const T lo_sum = occ * c.occ_l + (cnt - occ) * c.free_l;
      upd = upd || (cnt_i != 0u);
      const T avg = lo_sum / (cnt > one ? cnt : one);
      T update = avg;
      if (c.adaptive && occ > zero && avg > zero) {
        const T p = one / (one + exp_t(-v));
        const T scale = p <= c.thr ? (p / c.thr) * c.ratio : one;
        update = avg * scale;
      }
      T nv = v + update;
      nv = nv > c.lo_min ? nv : c.lo_min;
      nv = nv < c.lo_max ? nv : c.lo_max;
      v = cnt > zero ? nv : v;
      if (RAW) {
        if (occ_i != 0u) {
          atomicAdd(&stat_s[f], 1u);
        } else if (cnt_i != 0u) {
          atomicAdd(&stat_s[B + f], 1u);
        }
      }
    }
  }
  v_out[idx] = v;
  upd_out[idx] = upd;
}

// One block per tile of TB consecutive bricks.
template <typename T, bool RAW>
__global__ void __launch_bounds__(kMaxThreads) bin_apply_kernel(
    const int64_t* __restrict__ s_flat,
    const int64_t* __restrict__ s_pay,
    const int64_t* __restrict__ starts,
    const T* __restrict__ rows,
    T* __restrict__ v_out,
    bool* __restrict__ upd_out,
    unsigned long long* __restrict__ occ_u,   // (B,) RAW only
    unsigned long long* __restrict__ free_u,  // (B,) RAW only
    long long n_rec, int nb, int tb, int B, int vol, int f_bits, int o,
    ChainConsts<T> c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (B + 31) / 32;
  const int tvol = tb * vol;
  const int table = tb * B * vol;
  int64_t* st_s = reinterpret_cast<int64_t*>(smem);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + starts_bytes(tb));
  uint32_t* cnt_s = mask_s + nw * tvol;  // payloads (unique) or counts
  uint32_t* occ_s = cnt_s + table;       // RAW only
  uint32_t* stat_s = occ_s + table;      // RAW only
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tb;
  const int nt = static_cast<int>(min(static_cast<int64_t>(tb), nb - first));

  // the unique form's table is read only where a mask bit says it was
  // written, so only the masks (and the raw form's sums) start at zero
  zero_words(mask_s, nw * tvol + (RAW ? 2 * table + 2 * B : 0));
  for (int k = tid; k <= nt; k += blockDim.x) st_s[k] = starts[first + k];
  __syncthreads();

  const TileView t{st_s, nt, st_s[0], st_s[nt]};
  const uint32_t fmask = (1u << f_bits) - 1u;
  const int64_t p_end = (t.r1 + kRecs - 1) / kRecs;
  for (int64_t p = t.r0 / kRecs + tid; p < p_end; p += blockDim.x) {
    bin_group<RAW>(load_group(s_flat, s_pay, p, n_rec), p, t, B, vol, o,
                   fmask, tvol, mask_s, cnt_s, occ_s);
  }
  __syncthreads();

  // thread tid holds voxel tid % vol of the tile's brick tid / vol
  const int b = tid >> o;
  if (b < nt) {
    const int off = tid & (vol - 1);
    chain<T, RAW>(rows, v_out, upd_out, (first + b) * vol + off, b, off,
                  mask_s, cnt_s, occ_s, stat_s, nw, tvol, B, vol, c);
  }

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
           void* free_u, long long n_rec, int nb, int tb, int B, int vol,
           int f_bits, int o, ChainConsts<T> c, void* stream) {
  const int threads = tb * vol;
  if (tb < 1 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t bytes = smem_bytes(RAW, tb, B, vol);
  auto kernel = bin_apply_kernel<T, RAW>;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(nb + tb - 1) / tb, threads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s_flat),
      static_cast<const int64_t*>(s_pay),
      static_cast<const int64_t*>(starts), static_cast<const T*>(rows),
      static_cast<T*>(v_out), static_cast<bool*>(upd_out),
      static_cast<unsigned long long*>(occ_u),
      static_cast<unsigned long long*>(free_u), n_rec, nb, tb, B, vol, f_bits,
      o, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the first CUDA error of the launch.
// n_rec is the length of s_flat and s_pay, tb the bricks per block
// (tb * vol <= 512).  The raw forms ADD their per-frame counts into
// occ_u / free_u, (B,) int64 buffers the caller zeroes.
extern "C" int bin_apply_f32(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, long long n_rec, int nb, int tb,
                             int B, int vol, int f_bits, int o, float occ_l,
                             float free_l, int adaptive, float thr,
                             float ratio, float lo_min, float lo_max,
                             void* stream) {
  ChainConsts<float> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<float, false>(s_flat, s_pay, starts, rows, v_out, upd_out,
                              nullptr, nullptr, n_rec, nb, tb, B, vol, f_bits,
                              o, c, stream);
}

extern "C" int bin_apply_f64(const void* s_flat, const void* s_pay,
                             const void* starts, const void* rows, void* v_out,
                             void* upd_out, long long n_rec, int nb, int tb,
                             int B, int vol, int f_bits, int o, double occ_l,
                             double free_l, int adaptive, double thr,
                             double ratio, double lo_min, double lo_max,
                             void* stream) {
  ChainConsts<double> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<double, false>(s_flat, s_pay, starts, rows, v_out, upd_out,
                               nullptr, nullptr, n_rec, nb, tb, B, vol,
                               f_bits, o, c, stream);
}

extern "C" int bin_apply_raw_f32(const void* s_flat, const void* s_pay,
                                 const void* starts, const void* rows,
                                 void* v_out, void* upd_out, void* occ_u,
                                 void* free_u, long long n_rec, int nb,
                                 int tb, int B, int vol, int f_bits, int o,
                                 float occ_l, float free_l, int adaptive,
                                 float thr, float ratio, float lo_min,
                                 float lo_max, void* stream) {
  ChainConsts<float> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<float, true>(s_flat, s_pay, starts, rows, v_out, upd_out,
                             occ_u, free_u, n_rec, nb, tb, B, vol, f_bits, o,
                             c, stream);
}

extern "C" int bin_apply_raw_f64(const void* s_flat, const void* s_pay,
                                 const void* starts, const void* rows,
                                 void* v_out, void* upd_out, void* occ_u,
                                 void* free_u, long long n_rec, int nb,
                                 int tb, int B, int vol, int f_bits, int o,
                                 double occ_l, double free_l, int adaptive,
                                 double thr, double ratio, double lo_min,
                                 double lo_max, void* stream) {
  ChainConsts<double> c{occ_l, free_l, thr, ratio, lo_min, lo_max, adaptive};
  return launch<double, true>(s_flat, s_pay, starts, rows, v_out, upd_out,
                              occ_u, free_u, n_rec, nb, tb, B, vol, f_bits, o,
                              c, stream);
}
