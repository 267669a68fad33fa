// Leadership ordering on Hopper (sm_90a): the hand-written port of the
// Pallas TPU kernel kafka_assigner_tpu/ops/pallas_leadership.py::_kernel
// (wrapper leadership_order_pallas), which computes the reference's
// computePreferenceLists (KafkaAssignmentStrategy.java:202-302):
//
//   topics in order, partitions in order; for each slot r of a partition
//   with `count` candidates: m = max(count - r, 1), start = jhash mod m,
//   rot = (rank of the candidate among the remaining, by broker index,
//   + start) mod m; the slot takes the first minimum of the key
//   counters[cand][r]*m + rot and, when r < count, adds one to that
//   counter. Rows with count 0 or a partial count write -1 in their empty
//   slots.
//
// What bounds it: not bytes (about 6 MB at the 200k-partition config, a few
// microseconds at 3.35 TB/s) but a dependent chain. Slot r reads and writes
// only column r of the counter slab, so column r is one chain over the rows,
// and it meets the other columns only through its own row's "remaining" set
// (what slots 0..r-1 of that row chose). The design walks each column's
// chain once and keeps everything that does not depend on the counters off
// it:
//
//   1. prologue_kernel, one thread per row on many SMs: a record per row
//      with the count, the initial remaining mask, the gather rows clamped
//      into the slab, the raw candidates, for each candidate the mask of
//      candidates with a smaller broker index (so the rank among the
//      remaining is one popcount), and for every slot start_r = jhash mod
//      m_r (floor modulo, as torch and XLA take it) beside m_r. Nothing here
//      reads the counters.
//   2. chain_kernel, one warp: lane r owns column r. At step s it orders
//      slot r of row s - 2r; it gets that row's remaining mask from lane
//      r - 1 by one shuffle a step before it needs it. A row's counters are
//      loaded one step ahead, before this step's bump, and both keys are
//      kept: as loaded, and as if this step's bump hit them (the only write
//      that can alias them). The chain per step is then: compare gather row
//      with the bumped row -> select the key -> a first-minimum tree over
//      the RF keys -> the next bumped row. No shared-memory round trip and
//      no cross-lane reduction is on it; what bounds the kernel is the
//      warp's instruction issue for the work around it.
//      The (N_pad, RF) slab lives in dynamic shared memory, column-major,
//      when it fits with the tile rings; above the opt-in limit a template
//      switch keeps it in global memory (same chain, loads from L1/L2).
//   3. Records arrive in tiles of rows by TMA bulk copies into a ring of
//      kStages buffers completed on mbarriers, two tiles ahead of the lead
//      lane, and each tile's outputs are staged in shared memory and written
//      back by one bulk store. The ring is a power of two rows long, so a
//      row's buffer is `row & mask`, and the tile bookkeeping runs once per
//      tile of steps, not per step.
//
// Indices follow the JAX reference: a gather index is clamped into the slab
// and an out-of-range counter update is dropped (candidates of -1 gather
// and bump row 0; candidates >= N_pad gather row N_pad - 1 and bump none).
//
// Plain C interface (loaded with ctypes); the wrapper in ops/leadership.py
// allocates every output and the record scratch and checks shapes and types.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLag = 2;              // rows between neighbouring lanes
constexpr int kStages = 4;           // record / output tiles in the rings
constexpr int kChainThreads = 128;   // warp 0 walks; all stage the slab
constexpr int kPrologueThreads = 256;
constexpr long long kWaitCycles = 1LL << 35;  // a lost TMA traps, never hangs
constexpr int kMaxDevices = 16;

// Record of one row, in int32 words:
//   [0] count  [1] initial remaining mask  [2, 2+R) gather rows, clamped
//   into the slab and scaled to its row stride  [2+R, 2+2R) raw candidates  [2+2R, 2+3R) below_j: bit i set iff
//   cand_i < cand_j;  then from word pair_base(R): (start_r, m_r) pairs.
// The words before the pairs are read as int4s, a lane's pair as one int2;
// the record is a multiple of 4 words so every tile stays 16-byte aligned.
__host__ __device__ constexpr int head_quads(int R) { return (2 + 3 * R + 3) / 4; }
__host__ __device__ constexpr int pair_base(int R) { return (2 + 3 * R + 1) / 2 * 2; }
__host__ __device__ constexpr int record_words(int R) {
  return (pair_base(R) + 2 * R + 3) / 4 * 4;
}
__host__ __device__ constexpr int tile_rows(int R) { return R <= 4 ? 128 : 64; }
__host__ __device__ constexpr int ring_rows(int R) { return kStages * tile_rows(R); }
// The RF widths the chain is compiled for: each RF up to 4 (the common
// ones) and 32 for every RF above, whose extra candidates never remain.
__host__ __device__ constexpr int width_bucket(int rf) {
  return rf <= 4 ? rf : 32;
}

template <int R>
constexpr size_t ring_bytes() {
  return (size_t)ring_rows(R) * (record_words(R) + R) * 4 +
         kStages * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One thread: arm the barrier for `bytes` and start the bulk copy.
__device__ __forceinline__ void tile_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tile_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kPrologueThreads) prologue_kernel(
    const int* __restrict__ cand,     // (B, P, RF)
    const int* __restrict__ count,    // (B, P)
    const int* __restrict__ jhashes,  // (B,)
    int* __restrict__ records,        // (rows_pad, record_words(R))
    int rows, int rows_pad, int p, int rf, int R, int n_pad, int gstride) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows_pad) return;
  const int words = record_words(R);
  int* rec = records + (long long)row * words;
  const bool real = row < rows;
  const int cnt = real ? count[row] : 0;
  const int jh = real ? jhashes[row / p] : 0;
  const unsigned all = rf == 32 ? kFull : (1u << rf) - 1u;
  for (int w = 0; w < words; ++w) rec[w] = 0;
  rec[0] = cnt;
  rec[1] = (int)(cnt >= rf ? all : cnt > 0 ? (1u << cnt) - 1u : 0u);
  for (int j = 0; j < R; ++j) {
    const int cj = (real && j < rf) ? cand[(long long)row * rf + j] : -1;
    rec[2 + j] = min(max(cj, 0), n_pad - 1) * gstride;
    rec[2 + R + j] = cj;
    unsigned below = 0;
    for (int i = 0; i < rf && j < rf; ++i) {
      const int ci = real ? cand[(long long)row * rf + i] : -1;
      below |= (unsigned)(ci < cj) << i;
    }
    rec[2 + 2 * R + j] = (int)below;
  }
  for (int r = 0; r < R; ++r) {
    const int m = max(cnt - r, 1);
    int start = jh % m;
    if (start < 0) start += m;  // floor modulo, as torch and XLA take it
    rec[pair_base(R) + 2 * r] = start;
    rec[pair_base(R) + 2 * r + 1] = m;
  }
}

// One lane's record of one row, loaded two steps before its slot is ordered.
template <int R>
struct Rec {
  int w[4 * head_quads(R)];  // count, remaining mask, gather rows, candidates, below
  int start, m;              // this lane's slot
};

// One lane's slot of one row, prepared a step before its keys are compared.
template <int R>
struct Slot {
  int key[R];  // counter * m + rot, or kBig when not remaining
  int hit[R];  // the key had the previous step bumped this counter
  int g[R];    // gather row, scaled to the slab's row stride
  int c[R];    // raw candidate (the output)
  int v[R];    // counter as loaded
  unsigned rem;
  bool live;   // a real row, and a lane below RF
  bool slot;   // r < count: the slot writes and bumps
};

// What one lane of the chain warp keeps across steps.
struct Lane {
  const int* ring;  // record ring
  int* out;         // output ring
  int* slab;        // counters: shared (column-major) or global (row-major)
  int col_off;      // where this lane's column starts in it
  int lane, col, lag, rf, rows, n_pad;
  bool active;      // lane < rf
  int bumped;       // gather row bumped by this lane's last step, or -1
  unsigned from_left;  // lane - 1's remaining mask for this lane's next row
};

// Lanes at or above RF read the lead lane's records (one broadcast, no bank
// conflicts) and are never live. The ring starts zeroed and the prologue
// clamps every gather row, so a stale or unloaded record is harmless.
template <int R>
__device__ __forceinline__ void load_record(Rec<R>& x, const Lane& ln, int row) {
  const int* rec = ln.ring + (row & (ring_rows(R) - 1)) * record_words(R);
#pragma unroll
  for (int q = 0; q < head_quads(R); ++q) {
    const int4 v = reinterpret_cast<const int4*>(rec)[q];
    x.w[4 * q] = v.x;
    x.w[4 * q + 1] = v.y;
    x.w[4 * q + 2] = v.z;
    x.w[4 * q + 3] = v.w;
  }
  const int2 sm = *reinterpret_cast<const int2*>(rec + pair_base(R) + 2 * ln.col);
  x.start = sm.x;
  x.m = sm.y;
}

template <int R>
__device__ __forceinline__ void prepare(Slot<R>& s, const Rec<R>& x,
                                        const Lane& ln, int row,
                                        unsigned rem_in) {
  s.live = ln.active && (unsigned)row < (unsigned)ln.rows;
  const unsigned rem = ln.lane == 0 ? (unsigned)x.w[1] : rem_in;
  const unsigned m = (unsigned)x.m;
  s.rem = rem;
  s.slot = s.live && ln.lane < x.w[0];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int g = x.w[2 + j];
    s.g[j] = g;
    s.c[j] = x.w[2 + R + j];
    s.v[j] = ln.slab[ln.col_off + g];
    // rank < m and start < m, so one conditional subtract is the modulo
    const unsigned rot0 = __popc(rem & (unsigned)x.w[2 + 2 * R + j]) + x.start;
    const unsigned rot = min(rot0 - m, rot0);
    const bool alive = (rem & (1u << j)) != 0;
    // int32 arithmetic wraps as under torch and XLA
    const unsigned key = (unsigned)s.v[j] * m + rot;
    s.key[j] = alive ? (int)key : kBig;
    s.hit[j] = alive ? (int)(key + m) : kBig;
  }
}

// What a slot chose.
struct Pick {
  int g, c, v;   // gather row, candidate, counter as loaded
  unsigned bit;  // the candidate's bit in the remaining mask
};

// The part of a step that waits on the previous step: each key as loaded,
// or as bumped when the previous step bumped its gather row, then the first
// minimum in candidate order (a tree whose ties keep the lower index).
template <int R>
__device__ __forceinline__ Pick first_min(const Slot<R>& cur, int bumped) {
  int k[R], g[R], c[R], v[R];
  unsigned bit[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    k[j] = cur.g[j] == bumped ? cur.hit[j] : cur.key[j];
    bit[j] = 1u << j;
    g[j] = cur.g[j];
    c[j] = cur.c[j];
    v[j] = cur.v[j];
  }
#pragma unroll
  for (int d = 1; d < R; d *= 2) {
#pragma unroll
    for (int j = 0; j + d < R; j += 2 * d) {
      if (k[j + d] < k[j]) {
        k[j] = k[j + d];
        bit[j] = bit[j + d];
        g[j] = g[j + d];
        c[j] = c[j + d];
        v[j] = v[j + d];
      }
    }
  }
  return {g[0], c[0], v[0], bit[0]};
}

// Order `cur` (row), prepare `nxt` (row + 1) from `x_next`, and load the
// record of row + 2 into `x_after`.
template <int R>
__device__ __forceinline__ void step(Slot<R>& cur, Slot<R>& nxt,
                                     const Rec<R>& x_next, Rec<R>& x_after,
                                     Lane& ln, int row) {
  load_record<R>(x_after, ln, row + 2);
  // The next row's counter loads come before this step's bump in program
  // order, so they see every bump but this step's; the next step corrects.
  prepare<R>(nxt, x_next, ln, row + 1, ln.from_left);

  const Pick p = first_min<R>(cur, ln.bumped);
  const bool bump = cur.slot && p.c < ln.n_pad;
  const int now = p.v + (p.g == ln.bumped ? 1 : 0);
  if (bump) ln.slab[ln.col_off + p.g] = now + 1;
  ln.bumped = bump ? p.g : -1;
  if (cur.live)
    ln.out[(row & (ring_rows(R) - 1)) * ln.rf + ln.lane] = cur.slot ? p.c : -1;
  ln.from_left = __shfl_up_sync(kFull, cur.rem & ~p.bit, 1);
}

// The chain's floor, measured rather than assumed: one thread runs `steps`
// steps of the chain alone (first_min, then the next bumped row) on one
// slot read from `in` (key, hit, gather row, candidate and counter, `rf`
// words each, then the slot flag and N_pad), and writes the last bumped row
// and the clock64 cycles of the loop. Everything else a step does in
// chain_kernel depends only on earlier steps' loads and shuffles.
template <int R>
__global__ void chain_probe_kernel(const int* __restrict__ in, long long* out,
                                   int rf, long long steps) {
  Slot<R> s;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool on = j < rf;
    s.key[j] = on ? in[j] : kBig;
    s.hit[j] = on ? in[rf + j] : kBig;
    s.g[j] = on ? in[2 * rf + j] : 0;
    s.c[j] = on ? in[3 * rf + j] : -1;
    s.v[j] = on ? in[4 * rf + j] : 0;
  }
  s.slot = in[5 * rf] != 0;
  const int n_pad = in[5 * rf + 1];
  int bumped = -1;
  const long long t0 = clock64();
#pragma unroll 4
  for (long long i = 0; i < steps; ++i) {
    const Pick p = first_min<R>(s, bumped);
    bumped = s.slot && p.c < n_pad ? p.g : -1;
  }
  const long long t1 = clock64();
  out[0] = bumped;
  out[1] = t1 - t0;
}

template <int R, bool kShared>
__global__ void __launch_bounds__(kChainThreads, 1) chain_kernel(
    const int* __restrict__ records,  // (n_tiles * T, W) from the prologue
    int* counters,                    // (N_pad, RF) row-major, in and out
    int* __restrict__ ordered,        // (n_tiles * T, RF)
    int rows, int rf, int n_pad) {
  constexpr int W = record_words(R);
  constexpr int T = tile_rows(R);
  static_assert(kLag * (R - 1) <= T, "the skew must stay within a tile");
  static_assert(kStages == 4, "tile c + 2 is loaded into tile c - 2's buffer");
  extern __shared__ __align__(128) unsigned char smem[];
  int* in_ring = reinterpret_cast<int*>(smem);
  int* out_ring = in_ring + ring_rows(R) * W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_ring + ring_rows(R) * R);
  int* slab = kShared ? reinterpret_cast<int*>(bars + kStages) : counters;
  const int tid = threadIdx.x;

  if (kShared) {  // column-major copy: lane r's column is contiguous
    for (int g = tid; g < n_pad; g += kChainThreads)
      for (int r = 0; r < rf; ++r) slab[r * n_pad + g] = counters[g * rf + r];
  }
  for (int i = tid; i < ring_rows(R) * W; i += kChainThreads) in_ring[i] = 0;
  // The zeros must land before the bulk copies that overwrite them.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_u32(&bars[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32) {
    // Opaque to the compiler, so it keeps the lane's constants in registers
    // rather than recomputing them from the thread index on every step.
    int lane = tid;
    asm volatile("" : "+r"(lane));
    Lane ln;
    ln.lane = lane;
    ln.active = lane < rf;
    ln.col = min(lane, rf - 1);
    ln.lag = ln.active ? kLag * lane : 0;
    ln.rf = rf;
    ln.rows = rows;
    ln.n_pad = n_pad;
    ln.ring = in_ring;
    ln.out = out_ring;
    ln.slab = slab;
    ln.col_off = kShared ? ln.col * n_pad : ln.col;
    ln.bumped = -1;
    ln.from_left = 0;
    asm volatile("" : "+r"(ln.col_off), "+r"(ln.col), "+r"(ln.lag));
    const int n_tiles = (rows + T - 1) / T;
    const int n_chunks = (rows + kLag * (rf - 1) + T - 1) / T;
    const uint32_t in_bytes = T * W * 4;
    const uint32_t out_bytes = T * rf * 4;
    auto out_tile = [&](int t) {  // lane 0, after the lanes' fence
      tile_store(ordered + (long long)t * T * rf, out_ring + (t % kStages) * T * rf,
                 out_bytes);
    };
    if (ln.lane == 0)
      for (int t = 0; t < kStages && t < n_tiles; ++t)
        tile_load(in_ring + t * T * W, records + (long long)t * T * W, in_bytes,
                  &bars[t]);
    mbar_wait(&bars[0], 0);

    Slot<R> a, b;
    Rec<R> ra, rb;
    load_record<R>(ra, ln, -ln.lag);
    prepare<R>(a, ra, ln, -ln.lag, 0u);
    load_record<R>(ra, ln, 1 - ln.lag);
#pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      // Every lane has left tile ch - 2: write it back, load tile ch + 2
      // into its record buffer, and make sure the store that last read
      // tile ch's output buffer (tile ch - 4's) is done.
      if (ch >= 2) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (ln.lane == 0) {
          out_tile(ch - 2);
          const int t = ch + 2;
          if (t < n_tiles)
            tile_load(in_ring + (t % kStages) * T * W,
                      records + (long long)t * T * W, in_bytes,
                      &bars[t % kStages]);
          asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
        }
        __syncwarp();
      }
      // The lead lane reads rows up to (ch + 1) * T + 1 in this chunk.
      if (ch + 1 < n_tiles)
        mbar_wait(&bars[(ch + 1) % kStages], ((ch + 1) / kStages) & 1);
      const int row0 = ch * T - ln.lag;
#pragma unroll 2  // four steps per iteration: fewer loop overheads
      for (int k = 0; k < T; k += 2) {
        step<R>(a, b, ra, rb, ln, row0 + k);
        step<R>(b, a, rb, ra, ln, row0 + k + 1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (ln.lane == 0) {
      for (int t = max(n_chunks - 2, 0); t < n_tiles; ++t) out_tile(t);
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
  __syncthreads();
  if (kShared) {
    for (int g = tid; g < n_pad; g += kChainThreads)
      for (int r = 0; r < rf; ++r) counters[g * rf + r] = slab[r * n_pad + g];
  }
}

int device_index() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// Raise a kernel's dynamic shared-memory ceiling only when a launch needs
// more than it was last given on this device: once per size, not per launch.
template <int R, bool kShared>
cudaError_t ensure_smem(size_t bytes) {
  static int granted[kMaxDevices] = {0};
  const int dev = device_index();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (dev < kMaxDevices && (int)bytes <= granted[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<R, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = (int)bytes;
  return e;
}

template <int R>
size_t smem_bytes(int rf, int n_pad, bool global_slab) {
  return ring_bytes<R>() + (global_slab ? 0 : (size_t)rf * n_pad * 4);
}

template <int R>
int launch(const int* cand, const int* count, const int* jhashes, int* counters,
           int* ordered, int* records, int b, int p, int rf, int n_pad,
           bool global_slab, cudaStream_t s, cudaEvent_t mid) {
  const int rows = b * p;
  const int T = tile_rows(R);
  const int rows_pad = (rows + T - 1) / T * T;
  prologue_kernel<<<(rows_pad + kPrologueThreads - 1) / kPrologueThreads,
                    kPrologueThreads, 0, s>>>(cand, count, jhashes, records,
                                              rows, rows_pad, p, rf, R, n_pad,
                                              global_slab ? rf : 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (mid != nullptr && (e = cudaEventRecord(mid, s)) != cudaSuccess) return (int)e;
  const size_t bytes = smem_bytes<R>(rf, n_pad, global_slab);
  if (global_slab) {
    if ((e = ensure_smem<R, false>(bytes)) != cudaSuccess) return (int)e;
    chain_kernel<R, false><<<1, kChainThreads, bytes, s>>>(
        records, counters, ordered, rows, rf, n_pad);
  } else {
    if ((e = ensure_smem<R, true>(bytes)) != cudaSuccess) return (int)e;
    chain_kernel<R, true><<<1, kChainThreads, bytes, s>>>(
        records, counters, ordered, rows, rf, n_pad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on the current device.
int ka_smem_optin_limit() {
  int bytes = 0;
  const int dev = device_index();
  if (dev < 0 || cudaDeviceGetAttribute(
                     &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
                     cudaSuccess)
    return -1;
  return bytes;
}

// Rows per staged tile and int32 words per row record for this RF: the
// wrapper sizes the record scratch (whole tiles) and pads `ordered` to whole
// tiles with them.
int ka_leadership_tile_rows(int rf) { return tile_rows(width_bucket(rf)); }
int ka_leadership_record_words(int rf) {
  return record_words(width_bucket(rf));
}

// Dynamic shared memory one launch needs: the tile rings, plus the slab
// unless it stays in global memory.
long long ka_leadership_smem_bytes(int rf, int n_pad, int use_global_slab) {
  const bool g = use_global_slab != 0;
  switch (width_bucket(rf)) {
    case 1: return (long long)smem_bytes<1>(rf, n_pad, g);
    case 2: return (long long)smem_bytes<2>(rf, n_pad, g);
    case 3: return (long long)smem_bytes<3>(rf, n_pad, g);
    case 4: return (long long)smem_bytes<4>(rf, n_pad, g);
    default: return (long long)smem_bytes<32>(rf, n_pad, g);
  }
}

// One call orders the whole batch: the prologue over every row, then the
// chain in one CTA. `counters` holds the slab before the call and after it;
// `ordered` and `records` cover whole tiles. A non-null `mid_event` is
// recorded on the stream between the two launches, so a caller can time
// them apart. Returns the launches' cudaError_t (0 on success).
int ka_leadership_order(const int* cand, const int* count, const int* jhashes,
                        int* counters, int* ordered, int* records, int b, int p,
                        int rf, int n_pad, int use_global_slab, void* stream,
                        void* mid_event) {
  if (rf < 1 || rf > 32 || n_pad < 1 || b < 1 || p < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t mid = static_cast<cudaEvent_t>(mid_event);
  const bool g = use_global_slab != 0;
  switch (width_bucket(rf)) {
    case 1: return launch<1>(cand, count, jhashes, counters, ordered, records, b, p, rf, n_pad, g, s, mid);
    case 2: return launch<2>(cand, count, jhashes, counters, ordered, records, b, p, rf, n_pad, g, s, mid);
    case 3: return launch<3>(cand, count, jhashes, counters, ordered, records, b, p, rf, n_pad, g, s, mid);
    case 4: return launch<4>(cand, count, jhashes, counters, ordered, records, b, p, rf, n_pad, g, s, mid);
    default: return launch<32>(cand, count, jhashes, counters, ordered, records, b, p, rf, n_pad, g, s, mid);
  }
}

// The chain-floor probe (chain_probe_kernel) for this RF: `in` holds
// 5 * rf + 2 int32 words on the device, `out` two int64 words.
int ka_leadership_chain_probe(int rf, const int* in, long long* out,
                              long long steps, void* stream) {
  if (rf < 1 || rf > 32 || steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width_bucket(rf)) {
    case 1: chain_probe_kernel<1><<<1, 1, 0, s>>>(in, out, rf, steps); break;
    case 2: chain_probe_kernel<2><<<1, 1, 0, s>>>(in, out, rf, steps); break;
    case 3: chain_probe_kernel<3><<<1, 1, 0, s>>>(in, out, rf, steps); break;
    case 4: chain_probe_kernel<4><<<1, 1, 0, s>>>(in, out, rf, steps); break;
    default: chain_probe_kernel<32><<<1, 1, 0, s>>>(in, out, rf, steps); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
