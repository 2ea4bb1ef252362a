// The per-frame dedup's sort words of a batch of pings, straight from the
// pings and their poses, written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this part with plain
// jnp (sonar_3d_reconstruction_tpu/ops/backproject.py::backproject_ping,
// the floor keying and the key packing of ops/records.py), which XLA
// fuses on the TPU.  Unfused, the port ran it as ~140 int64 and float
// PyTorch passes a batch (ops/records.py::sort_words_plain, the plain
// version this kernel is held against bit for bit).
//
// What it computes.  For F frames (images (F, R, Bw), transforms (F, 4, 4))
// and the fan tables of ops/backproject.py, every candidate lane of the
// lattice, in backproject_ping's order: free lanes (ray, lane) first, then
// occupied lanes (ray, window bin, fan step).  A lane is valid when its
// free bin lies before its ray's first hit (or its occupied bin is a hit
// inside the window, its fan step within the bin's fan and its range
// inside [min_range, max_range]), its world z passes the z filter when it
// is on, and its frame is on.  A valid lane's voxel key floor(p / res) is
// packed in one of two forms: a box key (pack_box_keys against the box
// origin; the word is (box_key << 1) | occupied, 0xFFFFFFFF elsewhere,
// ops/dedup.py::compact_sort_words), or, without a box (`wide`), a brick
// code (pack_brick_keys joined by key_code; the word is (code << 1) |
// occupied, 2^63 - 1 elsewhere, ops/dedup.py::code_sort_words).  A key
// outside the box or the packable range leaves its lane empty.  Per frame
// it also reduces the int32 key bounds over the valid packed lanes (as
// their voxel centers), their count and whether a valid lane could not be
// packed.
//
// Design.  One block per (frame, block of kRays rays).
//   * Hits.  The block reads its rays' columns row by row (neighbouring
//     threads on neighbouring rays, so a warp's loads of a row share one or
//     two sectors) and sets one bit per above-threshold pixel in shared
//     memory, ceil((R + 1) / 32) words a ray.  A ray's first hit is its
//     lowest set bit (R when none); an occupied lane's hit test is one bit.
//     The image is read once; no (F, rays, R) profile or hit tensor exists.
//   * Lanes.  The block's lanes are two contiguous ranges of the output
//     row (its rays' free lanes, then its rays' occupied lanes), so thread
//     t writes lanes t, t + kThreads, ...: every store is coalesced.  A
//     thread steps its lane's (ray, lane) or (ray, bin, step) by kThreads
//     with carries, not divisions (integer division by a runtime width
//     costs as much as the lane's float work).  The
//     fan's vertical trig comes from the (nv_max + 1, S) tables that
//     _fan_trig builds on the device, so the kernel evaluates no trig.
//     Invalid lanes skip the float work and store the sentinel.
//   * Reductions.  Integer min / max / sum over the block by warp
//     reductions and shared atomics, then one 64-bit global atomic per
//     field and block into a (F, 9) buffer the wrapper initialises; the
//     last block of a frame to finish (a counter in the buffer, after a
//     fence) turns the frame's bounds into voxel centers.  Integer
//     reductions are exact and order-free, so the result does not depend
//     on the blocks' order.
//
// Rounding.  Built with --fmad=false and without fast math: every product
// and sum rounds on its own, in the order of the separate PyTorch ops
// (x = (r * cos_v) * cos_b, y = -((r * cos_v) * sin_b), z = r * sin_v,
// w = ((t0 * x + t1 * y) + t2 * z) + t3), the division p / res is IEEE's,
// and floor then the int32 conversion saturate as torch's .to(int32) does
// on the card.  Float constants arrive as doubles and are rounded to T
// once, as torch.full rounds them.  The intensity test compares in double
// against a threshold the wrapper has already rounded to the dtype torch
// compares in; every pixel kind the kernel reads is exact in double.
//
// What bounds it.  It must read the selected columns of the images (or,
// as it does, every row of them up to the image's depth) and write F * N
// int64 words; the tables are a few KB.  At the benchmark's batch (F = 64,
// N = 233,728, uint8 500 x 512 images) that is ~120 MB of words and 8 MB
// of selected pixels, ~38 us at 3.35 TB/s.  Measured on an H100 at that
// batch (chip_smoke.py phase 16; numbers in PERF.md): 0.156-0.157 ms in
// float32 (24 % of the bytes' bound), 0.176-0.177 ms in float64, against
// 7.4-9.7 ms for the plain chain.  Instruction throughput bounds it, not
// bytes: three IEEE divisions, the float work and the 64-bit packing of
// ~15 M lanes, 78 % of them valid.  Measured and kept: stepping each thread's
// lane indices instead of dividing by the runtime row widths (0.221 ->
// 0.159 ms in float32), and four blocks an SM (0.159 -> 0.156 ms; float64
// 0.219 -> 0.174 ms).  The benchmark's windows (64 pings, 0.08 m apart)
// do not fit box keys, so they take brick codes.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 16;  // rays a block, kernels/box_words.py
static_assert(kThreads % kRays == 0, "a thread reads one ray's column");
// blocks an SM holds: 64 registers a thread (float64 spills a few bytes,
// and still runs 20 % faster than at the 96 registers it would take)
constexpr int kMinBlocks = 4;
constexpr int kDefaultSmem = 48 * 1024;
constexpr long long kEmpty = 0xFFFFFFFFLL;     // ops/packing.py EMPTY32
constexpr long long kEmpty64 = LLONG_MAX;       // EMPTY64

// (F, kRedFields) int64 reduction buffer, kernels/box_words.py
enum { kMin = 0, kMax = 3, kCount = 6, kFail = 7, kDone = 8, kRedFields = 9 };

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }

// The fan tables of ops/backproject.py on the device (_device_tables,
// _fan_trig), in the map's dtype T where they are floats.
template <typename T>
struct Lattice {
  const int64_t* ray_idx;  // (n_rays,) image column of each ray
  const T* cos_b;          // (n_rays,)
  const T* sin_b;
  const int64_t* free_idx;  // (L,) range bin of each free lane
  const T* free_r;
  const T* free_cos_v;
  const T* free_sin_v;
  const bool* free_mask;  // (L,) range >= min_range
  const int64_t* occ_nv;  // (R + 1,) exact fan count of each bin
  const T* cos_t;         // (nv_max + 1, S) fan trig at row nv
  const T* sin_t;
  int n_rays, L, W, S, nvo_cap;
};

template <typename T>
struct Params {
  T res, rres, min_range, max_range, zmin;
  double thr;  // rounded to the dtype torch compares the pixels in
  int z_filter, R, Bw, img_kind, ax, ay, az, bb, box_stride;
  int wide;  // brick codes (no box) in place of box keys
};

__device__ __forceinline__ double pixel(const void* img, int kind,
                                        long long i) {
  if (kind == 0) return static_cast<const uint8_t*>(img)[i];
  if (kind == 1) return static_cast<const float*>(img)[i];
  return static_cast<const double*>(img)[i];
}

// A frame's sonar-to-world rows 0-2.
template <typename T>
struct Pose {
  T t00, t01, t02, t03, t10, t11, t12, t13, t20, t21, t22, t23;
};

// A thread's reductions over the lanes it packed.
struct Acc {
  int kmin[3] = {INT_MAX, INT_MAX, INT_MAX};
  int kmax[3] = {INT_MIN, INT_MIN, INT_MIN};
  unsigned int count = 0;
  bool fail = false;
};

// The word of a lane that passed its lattice tests, at range r, fan trig
// (cv, sv) and bearing trig (cb, sb): the sentinel where the z filter drops
// it or its key does not pack (fail), else (key << 1) | occ.
template <typename T>
__device__ __forceinline__ long long emit(T r, T cv, T sv, T cb, T sb,
                                          long long occ, const Pose<T>& t,
                                          const long long* box,
                                          const Params<T>& p, Acc& acc) {
  const long long empty = p.wide ? kEmpty64 : kEmpty;
  const T rcv = r * cv;
  const T x = rcv * cb;
  const T y = -(rcv * sb);
  const T z = r * sv;
  const T wz = t.t20 * x + t.t21 * y + t.t22 * z + t.t23;
  if (p.z_filter && !(wz >= p.zmin)) return empty;
  const T wx = t.t00 * x + t.t01 * y + t.t02 * z + t.t03;
  const T wy = t.t10 * x + t.t11 * y + t.t12 * z + t.t13;
  const int k0 = static_cast<int>(floor_t(wx / p.res));
  const int k1 = static_cast<int>(floor_t(wy / p.res));
  const int k2 = static_cast<int>(floor_t(wz / p.res));
  const int o = 3 * p.bb;
  const long long m = (1LL << p.bb) - 1;
  const long long rx = k0 - box[0], ry = k1 - box[1], rz = k2 - box[2];
  const long long off = ((rx & m) << (2 * p.bb)) | ((ry & m) << p.bb) |
                        (rz & m);
  long long bx = rx >> p.bb, by = ry >> p.bb, bz = rz >> p.bb;
  bool in;
  long long key;
  if (p.wide) {
    // pack_brick_keys' (hi, lo) as key_code joins them: for keys in range
    // the 60 bits are bx | by | bz | offset, a bits a field
    const int a = 20 - p.bb;  // ops/packing.py brick_layout
    const long long amax = (1LL << a) - 1, bias = 1LL << (a - 1);
    bx += bias;
    by += bias;
    bz += bias;
    in = bx >= 0 && by >= 0 && bz >= 0 && bx < amax && by <= amax &&
         bz <= amax;
    key = (bx << (2 * a + o)) | (by << (a + o)) | (bz << o) | off;
  } else {
    in = bx >= 0 && by >= 0 && bz >= 0 && bx < (1LL << p.ax) &&
         by < (1LL << p.ay) && bz < (1LL << p.az);
    key = (bx << (p.ay + p.az + o)) | (by << (p.az + o)) | (bz << o) | off;
  }
  if (!in) {
    acc.fail = true;
    return empty;
  }
  ++acc.count;
  acc.kmin[0] = min(acc.kmin[0], k0);
  acc.kmin[1] = min(acc.kmin[1], k1);
  acc.kmin[2] = min(acc.kmin[2], k2);
  acc.kmax[0] = max(acc.kmax[0], k0);
  acc.kmax[1] = max(acc.kmax[1], k1);
  acc.kmax[2] = max(acc.kmax[2], k2);
  return (key << 1) | occ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) box_words_kernel(
    const void* __restrict__ images, const T* __restrict__ transforms,
    const bool* __restrict__ frame_on, const int64_t* __restrict__ box_min,
    Lattice<T> lat, Params<T> p, long long N, int64_t* __restrict__ skey,
    long long* __restrict__ red, T* __restrict__ cmin, T* __restrict__ cmax,
    bool* __restrict__ range_fail, int64_t* __restrict__ n_valid) {
  extern __shared__ uint32_t bits[];  // kRays x hw hit words
  __shared__ int s_first[kRays];
  __shared__ T s_t[12];
  __shared__ long long s_box[3];
  __shared__ int s_kmin[3], s_kmax[3], s_fail;
  __shared__ unsigned int s_count;
  __shared__ bool s_last;

  const int f = blockIdx.y;
  const int r0 = blockIdx.x * kRays;
  const int nr = min(kRays, lat.n_rays - r0);
  const int hw = p.R / 32 + 1;  // bits 0..R; bit R (past the image) stays 0
  const bool on = frame_on == nullptr || frame_on[f];
  const int tid = threadIdx.x;

  for (int i = tid; i < kRays * hw; i += kThreads) bits[i] = 0;
  if (tid < 12) s_t[tid] = transforms[f * 16 + tid];
  if (tid < 3) {
    s_box[tid] = p.wide ? 0 : box_min[f * p.box_stride + tid];
    s_kmin[tid] = INT_MAX;
    s_kmax[tid] = INT_MIN;
  }
  if (tid == 0) {
    s_fail = 0;
    s_count = 0;
  }
  __syncthreads();

  // a thread reads one ray's column, every kThreads / kRays-th row
  const int ray1 = tid % kRays;
  if (on && ray1 < nr) {
    const long long col = static_cast<long long>(f) * p.R * p.Bw +
                          lat.ray_idx[r0 + ray1];
    for (int row = tid / kRays; row < p.R; row += kThreads / kRays) {
      if (pixel(images, p.img_kind, col + static_cast<long long>(row) * p.Bw)
          > p.thr)
        atomicOr(&bits[ray1 * hw + (row >> 5)], 1u << (row & 31));
    }
  }
  __syncthreads();
  if (tid < nr) {
    int first = p.R;
    for (int w = 0; w < hw; ++w) {
      const uint32_t b = bits[tid * hw + w];
      if (b) {
        first = w * 32 + __ffs(b) - 1;
        break;
      }
    }
    s_first[tid] = first;
  }
  __syncthreads();

  const Pose<T> pose{s_t[0], s_t[1], s_t[2],  s_t[3],  s_t[4],  s_t[5],
                     s_t[6], s_t[7], s_t[8], s_t[9], s_t[10], s_t[11]};
  const long long box[3] = {s_box[0], s_box[1], s_box[2]};
  const long long empty = p.wide ? kEmpty64 : kEmpty;
  int64_t* out = skey + f * N;
  Acc acc;

  // free lanes (ray, l): rows of L lanes from r0 * L on.  A thread steps
  // its (ray, l) by kThreads lanes without a division.
  {
    const int L = lat.L, nfree = nr * L;
    const int dr = kThreads / L, dl = kThreads % L;
    int ray = tid / L, l = tid % L;
    int64_t* o = out + static_cast<long long>(r0) * L;
    for (int j = tid; j < nfree; j += kThreads) {
      long long word = empty;
      if (on && lat.free_idx[l] < s_first[ray] && lat.free_mask[l])
        word = emit(lat.free_r[l], lat.free_cos_v[l], lat.free_sin_v[l],
                    lat.cos_b[r0 + ray], lat.sin_b[r0 + ray], 0LL, pose,
                    box, p, acc);
      o[j] = word;
      l += dl;
      ray += dr;
      if (l >= L) {
        l -= L;
        ++ray;
      }
    }
  }
  // occupied lanes (ray, w, s): rows of W * S lanes after every ray's free
  // lanes, stepped alike
  {
    const int S = lat.S, W = lat.W, ws = W * S, nocc = nr * ws;
    const int dray = kThreads / ws, drem = kThreads % ws;
    const int dw = drem / S, ds = drem % S;
    int ray = tid / ws, w = tid % ws / S, s = tid % ws % S;
    int64_t* o = out + static_cast<long long>(lat.n_rays) * lat.L +
                 static_cast<long long>(r0) * ws;
    for (int k = tid; k < nocc; k += kThreads) {
      long long word = empty;
      const int bin = min(s_first[ray] + w, p.R);
      const bool hit = (bits[ray * hw + (bin >> 5)] >> (bin & 31)) & 1u;
      const long long nv = hit ? lat.occ_nv[bin] : 0;  // occ_nv >= 2
      const T r = static_cast<T>(bin) * p.rres;
      if (on && nv > 0 && abs(s - lat.nvo_cap) <= nv && r >= p.min_range &&
          r <= p.max_range && bin < p.R)
        word = emit(r, lat.cos_t[nv * S + s], lat.sin_t[nv * S + s],
                    lat.cos_b[r0 + ray], lat.sin_b[r0 + ray], 1LL, pose,
                    box, p, acc);
      o[k] = word;
      s += ds;
      w += dw;
      ray += dray;
      if (s >= S) {
        s -= S;
        ++w;
      }
      if (w >= W) {
        w -= W;
        ++ray;
      }
    }
  }
  // block reduction: warps, then shared atomics, then one global atomic a
  // field
  const unsigned full = 0xffffffffu;
  const unsigned int count = __reduce_add_sync(full, acc.count);
  const bool lead = (tid & 31) == 0;
  for (int a = 0; a < 3; ++a) {
    const int lo = __reduce_min_sync(full, acc.kmin[a]);
    const int hi = __reduce_max_sync(full, acc.kmax[a]);
    if (lead && count) {
      atomicMin(&s_kmin[a], lo);
      atomicMax(&s_kmax[a], hi);
    }
  }
  if (__any_sync(full, acc.fail) && lead) s_fail = 1;
  if (lead && count) atomicAdd(&s_count, count);
  __syncthreads();

  long long* fr = red + static_cast<long long>(f) * kRedFields;
  if (tid == 0) {
    if (s_count) {
      for (int a = 0; a < 3; ++a) {
        atomicMin(&fr[kMin + a], static_cast<long long>(s_kmin[a]));
        atomicMax(&fr[kMax + a], static_cast<long long>(s_kmax[a]));
      }
      atomicAdd(reinterpret_cast<unsigned long long*>(&fr[kCount]),
                static_cast<unsigned long long>(s_count));
    }
    if (s_fail)
      atomicOr(reinterpret_cast<unsigned long long*>(&fr[kFail]), 1ull);
    __threadfence();
    const unsigned long long done = atomicAdd(
        reinterpret_cast<unsigned long long*>(&fr[kDone]), 1ull);
    s_last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || tid != 0) return;

  // the frame's last block: its fields are final
  __threadfence();
  const volatile long long* v = fr;
  const long long n = v[kCount];
  for (int a = 0; a < 3; ++a) {
    const T lo = (static_cast<T>(static_cast<int>(v[kMin + a])) + T(0.5)) *
                 p.res;
    const T hi = (static_cast<T>(static_cast<int>(v[kMax + a])) + T(0.5)) *
                 p.res;
    cmin[f * 3 + a] = n > 0 ? lo : T(INFINITY);
    cmax[f * 3 + a] = n > 0 ? hi : -T(INFINITY);
  }
  range_fail[f] = v[kFail] != 0;
  n_valid[f] = n;
}

template <typename T>
int launch(const void* images, int img_kind, const void* transforms,
           const void* frame_on, const void* box_min, int box_stride,
           const void* const* tab, void* skey, void* red, void* cmin,
           void* cmax, void* range_fail, void* n_valid, int F, int R, int Bw,
           int n_rays, int L, int W, int S, int nvo_cap, double thr,
           double res, double rres, double min_range, double max_range,
           int z_filter, double zmin, int ax, int ay, int az, int brick_bits,
           int wide, void* stream) {
  Lattice<T> lat{static_cast<const int64_t*>(tab[0]),
                 static_cast<const T*>(tab[1]),
                 static_cast<const T*>(tab[2]),
                 static_cast<const int64_t*>(tab[3]),
                 static_cast<const T*>(tab[4]),
                 static_cast<const T*>(tab[5]),
                 static_cast<const T*>(tab[6]),
                 static_cast<const bool*>(tab[7]),
                 static_cast<const int64_t*>(tab[8]),
                 static_cast<const T*>(tab[9]),
                 static_cast<const T*>(tab[10]),
                 n_rays, L, W, S, nvo_cap};
  Params<T> p{static_cast<T>(res), static_cast<T>(rres),
              static_cast<T>(min_range), static_cast<T>(max_range),
              static_cast<T>(zmin), thr, z_filter, R, Bw, img_kind, ax, ay,
              az, brick_bits, box_stride, wide};
  const long long N = static_cast<long long>(n_rays) * (L + W * S);
  const size_t smem = static_cast<size_t>(kRays) * (R / 32 + 1) *
                      sizeof(uint32_t);
  if (smem > kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rays + kRays - 1) / kRays, F);
  box_words_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      images, static_cast<const T*>(transforms),
      static_cast<const bool*>(frame_on),
      static_cast<const int64_t*>(box_min), lat, p, N,
      static_cast<int64_t*>(skey), static_cast<long long*>(red),
      static_cast<T*>(cmin), static_cast<T*>(cmax),
      static_cast<bool*>(range_fail), static_cast<int64_t*>(n_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the first CUDA error of the launch.
// `tab` holds the 11 table pointers in Lattice's order; `frame_on` may be
// null (every frame on); `box_stride` is 0 for one box, 3 for a box a
// frame; `red` is the (F, 9) buffer kernels/box_words.py initialises.
extern "C" int box_words_f32(
    const void* images, int img_kind, const void* transforms,
    const void* frame_on, const void* box_min, int box_stride,
    const void* const* tab, void* skey, void* red, void* cmin, void* cmax,
    void* range_fail, void* n_valid, int F, int R, int Bw, int n_rays, int L,
    int W, int S, int nvo_cap, double thr, double res, double rres,
    double min_range, double max_range, int z_filter, double zmin, int ax,
    int ay, int az, int brick_bits, int wide, void* stream) {
  return launch<float>(images, img_kind, transforms, frame_on, box_min,
                       box_stride, tab, skey, red, cmin, cmax, range_fail,
                       n_valid, F, R, Bw, n_rays, L, W, S, nvo_cap, thr, res,
                       rres, min_range, max_range, z_filter, zmin, ax, ay, az,
                       brick_bits, wide, stream);
}

extern "C" int box_words_f64(
    const void* images, int img_kind, const void* transforms,
    const void* frame_on, const void* box_min, int box_stride,
    const void* const* tab, void* skey, void* red, void* cmin, void* cmax,
    void* range_fail, void* n_valid, int F, int R, int Bw, int n_rays, int L,
    int W, int S, int nvo_cap, double thr, double res, double rres,
    double min_range, double max_range, int z_filter, double zmin, int ax,
    int ay, int az, int brick_bits, int wide, void* stream) {
  return launch<double>(images, img_kind, transforms, frame_on, box_min,
                        box_stride, tab, skey, red, cmin, cmax, range_fail,
                        n_valid, F, R, Bw, n_rays, L, W, S, nvo_cap, thr, res,
                        rres, min_range, max_range, z_filter, zmin, ax, ay,
                        az, brick_bits, wide, stream);
}
