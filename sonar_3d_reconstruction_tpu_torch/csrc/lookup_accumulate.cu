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
// Design.  The TPU kernel walks all records in one sequential loop with
// the whole table in VMEM.  A record only ever touches its own bucket, so
// buckets are independent and order matters only within one.  One call
// of k2_lookup_accumulate launches five kernels:
//   1. bucket pass: reads each record's key words once, computes mix2 in
//      u32 arithmetic and counts the active records of each bucket with
//      atomics;
//   2. allocation: each block scans its buckets' counts and takes their
//      range of the packed records with one atomic, which gives each
//      bucket its segment (start, count), and lists the buckets with more
//      than kWarpRecords records;
//   3. scatter: writes each active record once, as a 16-byte packed
//      record (hi, lo, upd bits, record index), into its bucket's segment
//      at a row taken from the segment's end with an atomic decrement;
//   4. long-segment sort: the atomics do not keep record order, so each
//      listed (long) segment is put back in record order by one block
//      with a stable LSD radix sort on the record index (4 passes of 8
//      bits, per-warp chunks ranked with __match_any_sync);
//   5. table kernel: one warp per bucket stages the bucket's 128 keys and
//      values in shared memory with a 256-entry hash of its occupied slots
//      (linear probing on 8 bits of another mix of the key), reads its
//      segment with coalesced 16-byte loads and, for a segment of at most
//      kWarpRecords, orders it by record index itself (rank by counting,
//      in shared memory).  Then, 32 records at a time in record order,
//      every lane finds its key through the hash at once; among the
//      records that miss (in a full bucket they all drop), the first
//      record of each key (__match_any_sync on the key; lanes are in
//      record order) is an insert at fill + its rank among such first
//      records, dropped at >= 128, and the key's later records take its
//      slot; adds to distinct slots run at once, adds to one slot one
//      after another in record order.  The warp writes the row back once.
//      Buckets without records are copied through, so the kernel writes
//      complete new tables and leaves its inputs untouched.
//
// What bounds it, measured (NVIDIA H100 80GB HBM3, 700 W;
// scripts/torch_k2_bench.py and chip_smoke.py).  Every call reads and
// writes both tables whole (NB * (256 * 8 + 128 * 4) bytes each way) plus
// 20 bytes per record: at U = 881,232 records into 2^22 slots that is
// 185,396,800 bytes, 0.0553 ms at 3.35 TB/s (111,238,080 bytes with u32
// key words).  The table kernel takes 0.061 ms there, 90 % of that bound
// (54 % of the u32 one; 96 % at U = 131,072 into 2^19, warm in L2), so
// it is bound by its table traffic.  The grouping kernels add 0.062 ms:
// the scatter's 881,232 random 16-byte writes (0.039 ms) and the bucket
// pass's atomics (0.019 ms).  A hot bucket (20,000 records of 400 keys)
// is walked by one warp in 625 batches of 32, 0.76 ms.
//
// Measured and left out (each timed in one call beside the kept form):
// comparing each key against the bucket's occupied slots one by one
// instead of the hash (the same time on spread buckets, 1.8x slower on
// the hot bucket); a 512-entry hash (2-4 % slower on spread buckets, 18 %
// faster on the hot one); ranks taken in the bucket pass so the scatter needs no
// atomic (the bucket pass slowed by what the scatter saved); the scatter
// reading each segment's start beside the atomic (no faster); grouping
// by a stable torch.sort of int32 bucket ids from the bucket pass, the
// yardstick (0.069 ms of sort kernels against 0.042 for allocation,
// scatter and long-segment sort).  More warps per block or two buckets
// per warp were not tried: the table kernel is at 90 % of its bound.
// One block scanning all counts, before the per-block allocation, took
// 0.035 ms (0.002 ms after, in the next call).
//
// Rounding.  One float32 addition per record, as in the plain version and
// the TPU kernel, in the same order within a slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 128;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpRecords = 64;   // longest segment a table warp orders
constexpr int kTableWarps = 8;     // buckets (warps) per table block
constexpr int kHash = 256;         // a table warp's hash of its slots
constexpr int kPassThreads = 256;  // bucket pass and scatter
constexpr int kAllocThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRadix = 256;

// ops/packing.py::mix2 in u32 arithmetic (the int64 version masks every
// product to 32 bits, which is u32 wrap-around)
__device__ __forceinline__ uint32_t mix2(uint32_t hi, uint32_t lo) {
  uint32_t h = (hi * 0x9E3779B1u) ^ (lo * 0x85EBCA6Bu);
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// a key's first position in its bucket's hash of slots: 8 bits of another
// mix than the one that chose the bucket
__device__ __forceinline__ int hash_pos(uint32_t hi, uint32_t lo) {
  return static_cast<int>(mix2(lo, hi) >> 24);
}

// Puts slot s of key (hi, lo) at its first free position from hash_pos
// (linear probing; at most 128 of the 256 positions are ever taken).
__device__ __forceinline__ void hash_insert(int* hash, uint32_t hi,
                                            uint32_t lo, int s) {
  int p = hash_pos(hi, lo);
  while (atomicCAS(&hash[p], -1, s) != -1) p = (p + 1) & (kHash - 1);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__global__ void __launch_bounds__(kPassThreads) k2_bucket_count_kernel(
    const int64_t* __restrict__ khi, const int64_t* __restrict__ klo,
    int64_t n, uint32_t mask, unsigned* __restrict__ counts,
    int32_t* __restrict__ ids) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPassThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = static_cast<uint32_t>(khi[i]);
  uint32_t b = mask + 1u;  // an inactive record's id: NB
  if (hi != kEmpty) {
    b = mix2(hi, static_cast<uint32_t>(klo[i])) & mask;
    atomicAdd(&counts[b], 1u);
  }
  if (ids != nullptr) ids[i] = static_cast<int32_t>(b);
}

// Each bucket's segment: (start, count) in seg.  Each block scans its
// buckets' counts and takes its range of the packed records with one
// atomic on the cursor, so segments lie in no particular bucket order but
// together fill [0, total).  Each count becomes its segment's end, from
// which the scatter counts down.  Also lists the buckets with more than
// kWarpRecords records.
__global__ void __launch_bounds__(kAllocThreads) k2_alloc_kernel(
    unsigned* __restrict__ counts, int nb, unsigned* __restrict__ cursor,
    int2* __restrict__ seg, int32_t* __restrict__ long_list,
    int32_t* __restrict__ n_long) {
  __shared__ unsigned warp_sum[kAllocThreads / 32];
  __shared__ unsigned base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x * kAllocThreads + t;
  const unsigned c = b < nb ? counts[b] : 0u;
  unsigned x = c;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kAllocThreads / 32 ? warp_sum[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kAllocThreads / 32) warp_sum[lane] = w;
    if (lane == 31) base = atomicAdd(cursor, w);  // w: the block's total
  }
  __syncthreads();
  if (b < nb) {
    const unsigned start = base + (warp > 0 ? warp_sum[warp - 1] : 0u) + x - c;
    seg[b] = make_int2(static_cast<int>(start), static_cast<int>(c));
    counts[b] = start + c;
    if (c > kWarpRecords) long_list[atomicAdd(n_long, 1)] = b;
  }
}

// A record's row is its bucket's segment end after an atomic decrement
// (ends: the counts as k2_alloc_kernel leaves them; each ends at its
// segment's start).
__global__ void __launch_bounds__(kPassThreads) k2_scatter_kernel(
    const int64_t* __restrict__ khi, const int64_t* __restrict__ klo,
    const float* __restrict__ upd, int64_t n, uint32_t mask,
    unsigned* __restrict__ ends, uint4* __restrict__ packed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPassThreads +
                    threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = static_cast<uint32_t>(khi[i]);
  if (hi == kEmpty) return;
  const uint32_t lo = static_cast<uint32_t>(klo[i]);
  const uint32_t b = mix2(hi, lo) & mask;
  packed[atomicSub(&ends[b], 1u) - 1u] = make_uint4(hi, lo, __float_as_uint(upd[i]),
                           static_cast<uint32_t>(i));
}

// One block per listed segment (blocks stride over the list): a stable LSD
// radix sort on the record index, 8 bits a pass, between the segment and
// the same range of `scratch`; four passes end in `packed`.  Each warp
// owns a contiguous chunk, so ranks by (digit, warp, lane) keep order.
__global__ void __launch_bounds__(kSortThreads) k2_sort_long_kernel(
    uint4* __restrict__ packed, uint4* __restrict__ scratch,
    const int2* __restrict__ seg, const int32_t* __restrict__ long_list,
    const int32_t* __restrict__ n_long) {
  __shared__ unsigned hist[kSortWarps][kRadix];
  __shared__ unsigned digit_base[kRadix];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = lanes_below(lane);
  const int listed = *n_long;
  for (int q = blockIdx.x; q < listed; q += gridDim.x) {
    const int2 sg = seg[long_list[q]];
    const int s0 = sg.x, n = sg.y;
    const int chunk = (n + kSortWarps - 1) / kSortWarps;
    const int w0 = min(n, warp * chunk);
    const int w1 = min(n, w0 + chunk);
    uint4* src = packed + s0;
    uint4* dst = scratch + s0;
    for (int shift = 0; shift < 32; shift += 8) {
      for (int k = t; k < kSortWarps * kRadix; k += kSortThreads) {
        hist[k / kRadix][k % kRadix] = 0u;
      }
      __syncthreads();
      for (int i = w0 + lane; i < w1; i += 32) {
        atomicAdd(&hist[warp][(src[i].w >> shift) & (kRadix - 1)], 1u);
      }
      __syncthreads();
      if (t < kRadix) {  // each digit's start within its warps, in warp order
        unsigned s = 0u;
        for (int w = 0; w < kSortWarps; ++w) {
          const unsigned c = hist[w][t];
          hist[w][t] = s;
          s += c;
        }
        digit_base[t] = s;
      }
      __syncthreads();
      if (warp == 0) {  // exclusive scan of the digit totals, 8 per lane
        constexpr int kPer = kRadix / 32;
        unsigned v[kPer];
        unsigned s = 0u;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          v[k] = digit_base[lane * kPer + k];
          s += v[k];
        }
        unsigned x = s;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        unsigned e = x - s;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          digit_base[lane * kPer + k] = e;
          e += v[k];
        }
      }
      __syncthreads();
      for (int base = w0; base < w1; base += 32) {
        const int i = base + lane;
        const bool valid = i < w1;
        const uint4 r = valid ? src[i] : make_uint4(0u, 0u, 0u, 0u);
        const unsigned d = (r.w >> shift) & (kRadix - 1);
        const unsigned valid_mask = __ballot_sync(kFull, valid);
        if (valid) {
          const unsigned peers = __match_any_sync(valid_mask, d);
          const unsigned at = digit_base[d] + hist[warp][d];
          dst[at + __popc(peers & below)] = r;
          __syncwarp(valid_mask);
          if ((peers & below) == 0u) hist[warp][d] += __popc(peers);
        }
        __syncwarp();
      }
      __syncthreads();
      uint4* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
}

__global__ void __launch_bounds__(32 * kTableWarps) lookup_accumulate_kernel(
    const uint4* __restrict__ packed,      // records grouped by bucket
    const int2* __restrict__ seg,          // (NB,) (start, count)
    const int64_t* __restrict__ rows_in,   // (NB, 256)
    const float* __restrict__ vals_in,     // (NB, 128)
    int64_t* __restrict__ rows_out, float* __restrict__ vals_out, int nb) {
  __shared__ uint2 s_key[kTableWarps][kSlots];  // (hi, lo) of each slot
  __shared__ float s_val[kTableWarps][kSlots];
  __shared__ uint4 s_rec[kTableWarps][kWarpRecords];
  __shared__ int s_hash[kTableWarps][kHash];    // slot at each position, or -1
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kTableWarps + warp;
  if (b >= nb) return;
  const unsigned below = lanes_below(lane);

  // 16-byte loads: pair p of the row holds int64 words 2p and 2p+1, so
  // pairs 0..63 are the hi words and 64..127 the lo words
  const longlong2* row =
      reinterpret_cast<const longlong2*>(rows_in + b * 2 * kSlots);
  const longlong2 h0 = row[lane], h1 = row[32 + lane];
  const longlong2 l0 = row[64 + lane], l1 = row[96 + lane];
  const float4 v = reinterpret_cast<const float4*>(vals_in + b * kSlots)[lane];
  const int2 sg = seg[b];
  const int s0 = sg.x, n = sg.y;
  longlong2* out = reinterpret_cast<longlong2*>(rows_out + b * 2 * kSlots);
  float4* vout = reinterpret_cast<float4*>(vals_out + b * kSlots);
  if (n == 0) {
    out[lane] = h0;
    out[32 + lane] = h1;
    out[64 + lane] = l0;
    out[96 + lane] = l1;
    vout[lane] = v;
    return;
  }

  uint2* key = s_key[warp];
  float* val = s_val[warp];
  key[2 * lane] = make_uint2(static_cast<uint32_t>(h0.x),
                             static_cast<uint32_t>(l0.x));
  key[2 * lane + 1] = make_uint2(static_cast<uint32_t>(h0.y),
                                 static_cast<uint32_t>(l0.y));
  key[64 + 2 * lane] = make_uint2(static_cast<uint32_t>(h1.x),
                                  static_cast<uint32_t>(l1.x));
  key[65 + 2 * lane] = make_uint2(static_cast<uint32_t>(h1.y),
                                  static_cast<uint32_t>(l1.y));
  reinterpret_cast<float4*>(val)[lane] = v;
  int* hash = s_hash[warp];
  reinterpret_cast<int4*>(hash)[lane] = make_int4(-1, -1, -1, -1);
  reinterpret_cast<int4*>(hash)[32 + lane] = make_int4(-1, -1, -1, -1);
  __syncwarp();
  // the occupied slots into the hash; prefix fill: the first empty slot is
  // the number of occupied ones
  int fill = kSlots;
  const int64_t his[4] = {h0.x, h0.y, h1.x, h1.y};
  const int64_t los[4] = {l0.x, l0.y, l1.x, l1.y};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t hi = static_cast<uint32_t>(his[j]);
    if (hi != kEmpty) {
      hash_insert(hash, hi, static_cast<uint32_t>(los[j]),
                  (j >> 1) * 64 + 2 * lane + (j & 1));
    }
    fill -= __popc(__ballot_sync(kFull, hi == kEmpty));
  }
  __syncwarp();

  // A short segment comes in scatter order: rank each record by counting
  // the smaller record indices, and place it at its rank.  A long one was
  // put in record order by k2_sort_long_kernel.
  const bool staged = n <= kWarpRecords;
  uint4* rec = s_rec[warp];
  if (staged) {
    const bool v0 = lane < n, v1 = 32 + lane < n;
    const uint4 r0 = v0 ? packed[s0 + lane] : make_uint4(0u, 0u, 0u, 0u);
    const uint4 r1 = v1 ? packed[s0 + 32 + lane] : make_uint4(0u, 0u, 0u, 0u);
    if (v0) rec[lane] = r0;
    if (v1) rec[32 + lane] = r1;
    __syncwarp();
    int k0 = 0, k1 = 0;
    for (int k = 0; k < n; ++k) {
      const uint32_t x = rec[k].w;
      k0 += x < r0.w;
      k1 += x < r1.w;
    }
    __syncwarp();
    if (v0) rec[k0] = r0;
    if (v1) rec[k1] = r1;
    __syncwarp();
  }

  // a long segment is read one batch ahead
  uint4 ahead = make_uint4(0u, 0u, 0u, 0u);
  if (!staged) ahead = packed[s0 + lane];
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool act = i < n;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (staged) {
      if (act) r = rec[i];
    } else {
      r = ahead;
      if (i + 32 < n) ahead = packed[s0 + i + 32];
    }
    // find: the slot that holds the key, through the hash
    int slot = -1;
    if (act) {
      for (int p = hash_pos(r.x, r.y);; p = (p + 1) & (kHash - 1)) {
        const int s = hash[p];
        if (s < 0) break;
        const uint2 kk = key[s];
        if (kk.x == r.x && kk.y == r.y) {
          slot = s;
          break;
        }
      }
    }
    // a full bucket drops every record that misses
    const bool miss = act && slot < 0 && fill < kSlots;
    const unsigned miss_mask = __ballot_sync(kFull, miss);
    if (miss_mask != 0u) {
      // the first record of each missing key inserts it; lanes are in
      // record order, so that is the lowest lane holding the key
      unsigned peers = 0u;
      if (miss) {
        peers = __match_any_sync(
            miss_mask, (static_cast<unsigned long long>(r.x) << 32) | r.y);
      }
      const int first = miss ? __ffs(peers) - 1 : lane;
      const unsigned firsts = __ballot_sync(kFull, miss && first == lane);
      const int mine = fill + __popc(firsts & below);
      const int got = __shfl_sync(kFull, mine, first);
      if (miss && got < kSlots) {  // at >= 128 the key's records drop
        slot = got;
        if (first == lane) {
          key[got] = make_uint2(r.x, r.y);
          hash_insert(hash, r.x, r.y, got);
        }
      }
      fill = min(kSlots, fill + __popc(firsts));
      __syncwarp();
    }
    // adds: one turn per record of a slot, in record (lane) order
    const bool add = act && slot >= 0;
    const unsigned add_mask = __ballot_sync(kFull, add);
    int turn = 0;
    if (add) turn = __popc(__match_any_sync(add_mask, slot) & below);
    const int turns = __reduce_max_sync(kFull, static_cast<unsigned>(turn));
    for (int q = 0; q <= turns; ++q) {
      if (add && turn == q) val[slot] = val[slot] + __uint_as_float(r.z);
      __syncwarp();
    }
  }

  const uint2 a = key[2 * lane], c = key[2 * lane + 1];
  const uint2 e = key[64 + 2 * lane], f = key[65 + 2 * lane];
  out[lane] = make_longlong2(a.x, c.x);
  out[32 + lane] = make_longlong2(e.x, f.x);
  out[64 + lane] = make_longlong2(a.y, c.y);
  out[96 + lane] = make_longlong2(e.y, f.y);
  vout[lane] = reinterpret_cast<const float4*>(val)[lane];
}

unsigned pass_blocks(int64_t n) {
  return static_cast<unsigned>((n + kPassThreads - 1) / kPassThreads);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after its launches.
// Record counts n < 2^31; nb a power of two.

// The bucket pass alone: counts (NB + 2,) u32 (the per-bucket counts,
// then two words the grouping uses) and each record's bucket (NB if
// inactive) in ids (n,) when non-null.
extern "C" int k2_bucket_pass(const void* khi, const void* klo, long long n,
                              int nb, void* counts, void* ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, sizeof(unsigned) * (nb + 2), s);
  if (n > 0) {
    k2_bucket_count_kernel<<<pass_blocks(n), kPassThreads, 0, s>>>(
        static_cast<const int64_t*>(khi), static_cast<const int64_t*>(klo), n,
        static_cast<uint32_t>(nb - 1), static_cast<unsigned*>(counts),
        static_cast<int32_t*>(ids));
  }
  return static_cast<int>(cudaGetLastError());
}

// The grouping: bucket pass, allocation, scatter and long-segment sort.
// `work` (4 NB + 2,) int32 receives seg (NB, 2) (start, count) in its
// first 2 NB words (the rest is scratch: counts, the cursor, the number
// of long segments and their list); `packed` (2n, 4) int32 receives the
// grouped records in its first n rows (the rest is the sort's scratch).
extern "C" int k2_group(const void* khi, const void* klo, const void* upd,
                        long long n, int nb, void* work, void* packed,
                        int sort_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* seg = static_cast<int2*>(work);
  unsigned* counts = static_cast<unsigned*>(work) + 2 * nb;
  int32_t* n_long = reinterpret_cast<int32_t*>(counts + nb + 1);
  int32_t* long_list = n_long + 1;
  uint4* rec = static_cast<uint4*>(packed);
  int err = k2_bucket_pass(khi, klo, n, nb, counts, nullptr, stream);
  if (err != 0) return err;
  k2_alloc_kernel<<<(nb + kAllocThreads - 1) / kAllocThreads, kAllocThreads,
                    0, s>>>(counts, nb, counts + nb, seg, long_list, n_long);
  if (n > 0) {
    k2_scatter_kernel<<<pass_blocks(n), kPassThreads, 0, s>>>(
        static_cast<const int64_t*>(khi), static_cast<const int64_t*>(klo),
        static_cast<const float*>(upd), n, static_cast<uint32_t>(nb - 1),
        counts, rec);
  }
  if (n > kWarpRecords) {
    k2_sort_long_kernel<<<sort_blocks, kSortThreads, 0, s>>>(
        rec, rec + n, seg, long_list, n_long);
  }
  return static_cast<int>(cudaGetLastError());
}

// New tables from the grouped records.
extern "C" int lookup_accumulate(const void* packed, const void* seg,
                                 const void* rows_in, const void* vals_in,
                                 void* rows_out, void* vals_out, int nb,
                                 void* stream) {
  const int blocks = (nb + kTableWarps - 1) / kTableWarps;
  lookup_accumulate_kernel<<<blocks, 32 * kTableWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(packed), static_cast<const int2*>(seg),
      static_cast<const int64_t*>(rows_in), static_cast<const float*>(vals_in),
      static_cast<int64_t*>(rows_out), static_cast<float*>(vals_out), nb);
  return static_cast<int>(cudaGetLastError());
}

// The whole function, group_records and apply_grouped in one: `buf`
// (8n + 4 NB + 2,) int32 holds the packed records and their scratch
// (2n rows of 4 words), then `work` as k2_group takes it.
extern "C" int k2_lookup_accumulate(const void* khi, const void* klo,
                                    const void* upd, long long n,
                                    const void* rows_in, const void* vals_in,
                                    void* rows_out, void* vals_out, int nb,
                                    void* buf, int sort_blocks, void* stream) {
  int32_t* packed = static_cast<int32_t*>(buf);
  int32_t* work = packed + 8 * n;
  const int err = k2_group(khi, klo, upd, n, nb, work, packed, sort_blocks,
                           stream);
  if (err != 0) return err;
  return lookup_accumulate(packed, work, rows_in, vals_in, rows_out, vals_out,
                           nb, stream);
}
