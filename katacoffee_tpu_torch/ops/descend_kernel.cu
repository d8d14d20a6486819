// Interior descent of the batched MCTS, fused into one launch per
// simulation, for Hopper (sm_90a).
//
// Replaces the lock-step interior levels of `_simulate_once` (the `body` of
// the while_loop at katacoffee_tpu/search/mcts.py:1267, and
// `_descend_interior_plain` in katacoffee_tpu_torch/search/mcts.py), and
// with them the per-level child-stats gather, the Pallas TPU kernel
// `_gather_kernel` of katacoffee_tpu/ops/gather.py:39.
//
// One warp walks one game (or, in a round of K playouts a game, one row of
// B * K: see the rows flag below) from the node after the root level down
// to its leaf. Per level, lane l takes the candidate lanes c = l and c = l + 32 of
// the node's last-move line (C <= 63 lanes):
//   * the candidate-table row cand[spot, dir, c], from shared memory;
//   * the compact children / edge_visits / prior entries at cand;
//   * each live child's 32-byte stats row as two float4 loads (the gather,
//     now into registers), and with it that child's is_terminal, last_spot,
//     last_dir and own utility: the next level's node fields, if the warp
//     steps to that child;
// then the edge stats (`_edge_stats_from_raw`) and the PUCT score
// (`_selection_compact`) of each lane, two warp sums and a warp argmax that
// keeps the lowest lane on ties, as torch.argmax does (one redux.sync of the
// scores as ordered keys and two ballots, where a tree of shuffles waits on
// five). Under graph search the chosen edge is caught up (`want_catch_at`,
// the JAX package's search/mcts.py:1209, used at :1333) when it has fewer
// visits than its child: has_child && (float)edge_visits < child S_VISITS -
// 0.5f. Lane 0 records the chosen lane in acts[depth] (also where the child
// is missing or caught up: the expansion reads it), the lanes write the
// level's scratch slot depth-1 for the backup, lane 0 counts the edge visit
// when it moves on, the game is marked caught on a catch-up, and the warp
// steps to the child. It stops at a terminal node, a missing child, a
// catch-up or depth == D.
//
// Four template flags, the launch picking the kernel instantiated for them,
// so a flag that is off costs nothing and its tensor is never read (its
// pointer may be a dummy). Two follow lanes of the search options (flags of
// Select):
//   * rank (useNoisePruning): each lane stores float(policy_rank[b, node,
//     cand]) into the scratch's rank_c, 1e6 on a padding lane, for the
//     backup's prefix sums;
//   * forbid (avoid_until): a lane is forbidden where avoid_until[b, mover
//     - 1, cand] > depth, mover the player to move at the node (the first
//     node's is loaded, and it alternates down the path: every move passes
//     the turn); a forbidden lane scores -inf, unless no lane with a prior
//     >= 0 is left unforbidden (a warp vote), when the mask is ignored
//     (`_avoid`, the JAX package's `keep`, search/mcts.py:764).
// Both loads are in round trip (a) below, next to the compact entries, so
// neither adds a dependent trip. Two follow the launch:
//   * leak (graphSearchCatchUpLeakProb > 0, `_leaked`, the JAX package's
//     search/mcts.py:1215-1219): a catch-up is let through where the row's
//     uniform draw leak_u[row, depth] < leak_prob, float32 against float32;
//     the draw is loaded with trip (a);
//   * rows (numSearchThreads = K > 1, `_simulate_round`, :1785-1884): a warp
//     walks one row of B * K, row r being playout r % K of game r / K. The
//     tree's tensors are the game's, the inputs and outputs (node, depth,
//     active, path, acts, scratch, leaf, caught) the row's. K rows of a game
//     may pass one edge, and the JAX round reads a level's edge visits before
//     any row of that level adds to them, so this mode writes no edge visit:
//     lane 0 records the chosen lane's flat action in acts_f[depth] and the
//     caller adds the visits after the launch in one integer scatter-add
//     (`mcts._count_path_edges`). As Coffee's DAG is graded (a ply fills one
//     spot), a node at depth d is read only at level d, so no row could have
//     seen another level's adds either.
//
// Numerics: every operation is the plain torch version's, in its order, each
// rounded to float32 (built with --fmad=false, IEEE division and square
// root); a division by a Python scalar is torch's multiply by the float32
// reciprocal; the two sums follow torch's CUDA reduction of a [B, C] row
// (block width min(last_pow2(C), 32), one strided partial per lane, then
// shfl_down with decreasing offsets); fpuParentWeightByVisitedPolicyPow
// takes torch.pow's special cases for 0, 1, 2, 3, 0.5, -0.5, -1 and -2.
//
// Bound: latency. A game-level moves about C*(12 + 32 + 21 + 44) + 20 bytes
// (compact entries, child rows and node fields, the scratch slot, the act
// and path), under 1 us of HBM time for a B=512 5x5 search, but the levels
// of a game are serial: the kernel's time is the deepest game's levels
// times one level's chain of dependent memory trips, arithmetic and warp
// communication. The design keeps the memory to two dependent global round
// trips a level:
//   (a) the compact entries at the candidates, whose addresses come from the
//       candidate row in shared memory: each block copies the whole table
//       (int16, [area + 1, 5, C], 5.2 KB for 5x5, 136 KB for 15x15) into
//       dynamic shared memory once, with one TMA bulk copy completed on an
//       mbarrier, while its warps load their first node's fields;
//   (b) the children's stats rows together with the children's node fields,
//       all independent loads of one round trip; after the argmax the chosen
//       lane's values are shuffled to the warp, so the next node's fields,
//       stats row and own utility are in registers when the next level
//       starts (none of them changes during a launch: the stats, self stats
//       and states are written only between launches);
//   the edge visit is written, not incremented: each lane keeps the count it
//   loaded for its candidate and lane 0 stores the chosen lane's count + 1,
//   a store the warp does not wait for.
// What is left is mostly arithmetic and warp communication: a copy with
// clock reads (tools/kernel_ab.py) on an H100 80GB HBM3 at 1,980 MHz spent
// ~3,200 cycles a level on a gating tree in L2: trip (a) ~235, trip (b)
// with the lanes' edge stats ~1,130, the two sums ~470 and the scores,
// argmax and chosen lane ~1,020 (IEEE division, square root and log in
// series, as the bit-identity needs). On a tree larger than L2, trip (b)
// grows to ~2,700. So the two sums run their shuffle trees side by side and
// the argmax is one redux; guessing the next node (the most visited child)
// and loading its entries with trip (b), to skip trip (a) on a hit, was
// slower.
// Only the first level pays one more trip, for the first node's fields. No
// atomics and no re-read: with one row a game a warp is the only writer of
// its game's tree, and a path never repeats a node (each ply fills one more
// spot); with K rows a game (rows) no warp writes the tree. A block holds
// 4 warps (games): of 1, 2 and 4 it was the best or within 1 % of the best
// on every tree measured (tools/kernel_ab.py).
//
// Built by katacoffee_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kSlots = 2;  // candidate lanes per thread
constexpr unsigned kFull = 0xffffffffu;
#define KC_NEG_INF __int_as_float(0xff800000)

// fpu modes (0: the parent's utility): fpuParentWeightByVisitedPolicy,
// fpuParentWeight
constexpr int kFpuVisitedPolicy = 1, kFpuParentWeight = 2;
// torch.pow(tensor, scalar) special cases (0: powf)
constexpr int kPowZero = 1, kPowOne = 2, kPowTwo = 3, kPowThree = 4, kPowHalf = 5,
              kPowMinusHalf = 6, kPowMinusOne = 7, kPowMinusTwo = 8;

// SearchParams constants, each rounded to float32 as torch rounds a Python
// scalar against a float32 tensor (kc_descend_interior's argument order).
struct Select {
  float cpuct, cpuct_log, cpuct_base, inv_cpuct_base;
  float stdev_scale, stdev_prior, inv_stdev_prior, var_prior, stdev_prior_weight;
  float fpu_reduction_max, fpu_loss_prop, neg_wl_factor;
  float fpu_parent_weight, one_minus_fpu_parent_weight, visited_pow;
  float eps;
  int stdev_on, fpu_mode, pow_mode, graph, rank_on, forbid_on;
};
constexpr int kNumFloats = 16;
constexpr int kNumInts = 6;
constexpr int kNumPointers = 27;  // kc_descend_interior's tensor arguments
constexpr float kNoRank = 1e6f;   // rank_c on a padding lane
// A block's shared memory on sm_90 (227 KB) less the mbarrier's 16 bytes.
constexpr int kMaxTableBytes = 232432;

struct Args {
  const long long* last_spot;     // [B, N]
  const long long* last_dir;      // [B, N]
  const unsigned char* terminal;  // [B, N] bool
  const short* cand;              // [area + 1, 5, C] int16, -1 padded; -1s to 16 bytes
  const int* children;            // [B, N, A]
  int* edge_visits;               // [B, N, A], counted along the path
  const float* prior;             // [B, N, A]
  const float4* stats;            // [B, N, 8] as [B, N, 2] float4
  const float* self_stats;        // [B, N, 4]
  const signed char* to_move;     // [B, N] int8, 1 or 2
  const int* policy_rank;         // [B, N, A] (rank_on)
  const int* avoid_until;         // [B, 2, A] (forbid_on)
  const float* leak_u;            // [R, D + 1] (leak)
  // R rows: B, or B * K with K rows a game (rows)
  const long long* node0;         // [R]
  const long long* depth0;        // [R]
  const unsigned char* active0;   // [R] bool
  long long* path;                // [R, D + 1]
  long long* acts;                // [R, D + 1]
  long long* acts_f;              // [R, D + 1] (rows)
  float4* cs_raw;                 // [R, D, C, 8] as [R, D, C, 2] float4
  float* prior_c;                 // [R, D, C]
  int* child_c;                   // [R, D, C]
  float* ev_c;                    // [R, D, C]
  float* rank_c;                  // [R, D, C] (rank_on)
  long long* leaf;                // [R]
  long long* leaf_depth;          // [R]
  unsigned char* caught;          // [R] bool, stopped by a catch-up
  int b, n, a, c, d, area, table_bytes;  // b: the rows R
  int k;                                 // rows a game
  float leak_prob;
};

// The candidate-table bytes the kernel copies: (area + 1) * 5 * C int16,
// rounded up to the bulk copy's 16-byte granule.
int table_bytes(int area, int c) { return ((area + 1) * 5 * c * 2 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: arm `bar` for `bytes` and start the TMA bulk copy of `bytes`
// from global `src` to shared `dst`, which completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Waits until `bar` completes its first phase.
__device__ __forceinline__ void wait_first_phase(uint64_t* bar) {
  const uint32_t parity = 0;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The candidate-table row of a node whose last move was (spot, dir): no
// last move (spot < 0, or dir 4) reads a row of -1s.
__device__ __forceinline__ int cand_row(long long spot, long long dir, int area) {
  spot = (spot < 0 || spot > area) ? area : spot;
  dir = dir < 0 ? 0 : (dir > 4 ? 4 : dir);
  return static_cast<int>(spot * 5 + dir);
}

__device__ __forceinline__ float pow_scalar(float x, float e, int mode) {
  switch (mode) {
    case kPowZero: return 1.0f;
    case kPowOne: return x;
    case kPowTwo: return x * x;
    case kPowThree: return x * x * x;
    case kPowHalf: return sqrtf(x);
    case kPowMinusHalf: return rsqrtf(x);
    case kPowMinusOne: return 1.0f / x;
    case kPowMinusTwo: return 1.0f / (x * x);
    default: return powf(x, e);
  }
}

// The sums of two rows of C lane values, x[k] and y[k] (lane c = lane + 32 k,
// 0 past C), each in the order of torch's CUDA sum over the last dim of a
// contiguous [B, C] tensor (block width min(last_pow2(C), 32), one strided
// partial per lane, then shfl_down with decreasing offsets); every lane gets
// both. The two trees go step by step together, so that each step's two
// shuffles are in flight at once: the warp waits on one shuffle a step, not
// two.
__device__ __forceinline__ float2 torch_row_sums(const float (&x)[kSlots], const float (&y)[kSlots],
                                                 int lane, int c, int width) {
  float v, u;
  if (width == 32) {
    v = x[0] + x[1];
    u = y[0] + y[1];
  } else {  // c < 2 * width: lane l adds lane l + width
    const float xu = __shfl_down_sync(kFull, x[0], width);
    const float yu = __shfl_down_sync(kFull, y[0], width);
    v = x[0] + (lane + width < c ? xu : 0.0f);
    u = y[0] + (lane + width < c ? yu : 0.0f);
  }
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float vo = __shfl_down_sync(kFull, v, off);
    const float uo = __shfl_down_sync(kFull, u, off);
    v += vo;
    u += uo;
  }
  const float v0 = __shfl_sync(kFull, v, 0);
  const float u0 = __shfl_sync(kFull, u, 0);
  return make_float2(v0, u0);
}

// A float score as an unsigned key in the same order (-0 as +0, as the
// float comparison has it), so that a warp's maximum is one redux.
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <bool kRank, bool kForbid, bool kLeak, bool kRows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
descend_interior_kernel(Args g, Select s) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) unsigned char table[];
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) bulk_copy(table, g.cand, g.table_bytes, &bar);
  const short* cand_tab = reinterpret_cast<const short*>(table);

  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // whole warps leave together; warp 0, which waits for the copy, has b < B
  if (b >= g.b) return;
  const int C = g.c;
  const int width = min(32, 1 << (31 - __clz(C)));  // last_pow2(C), capped
  const int game = kRows ? b / g.k : b;
  const long long row0 = static_cast<long long>(game) * g.n;
  const long long prow = static_cast<long long>(b) * (g.d + 1);
  long long node = g.node0[b];
  long long depth = g.depth0[b];
  bool active = g.active0[b] != 0;
  bool caught = false;

  // The node's fields, stats row (visits, w, wsq, u | usq, ...) and own
  // utility: the first node's loaded here while the table arrives, every
  // later node's taken from the chosen lane of the level above.
  bool term = false;
  int row = 0, mover = 1;
  float ns_w = 0.0f, ns_u = 0.0f, ns_usq = 0.0f, self_u = 0.0f;
  if (active) {
    const long long bn = row0 + node;
    term = __ldg(g.terminal + bn) != 0;
    if (kForbid) mover = __ldg(g.to_move + bn);
    row = cand_row(__ldg(g.last_spot + bn), __ldg(g.last_dir + bn), g.area);
    const float4 lo = __ldg(g.stats + bn * 2);
    ns_w = lo.y;
    ns_u = lo.w;
    ns_usq = __ldg(g.stats + bn * 2 + 1).x;
    self_u = __ldg(g.self_stats + bn * 4);
  }
  wait_first_phase(&bar);

  while (active) {
    const long long bn = row0 + node;
    const short* cand_r = cand_tab + row * C;
    const long long slot = (static_cast<long long>(b) * g.d + (depth - 1)) * C;

    // round trip (a): the compact entries at the candidates, with the
    // rank and forbid lanes
    const long long arow = (static_cast<long long>(game) * 2 + min(max(mover - 1, 0), 1)) * g.a;
    const float u = kLeak ? __ldg(g.leak_u + prow + depth) : 0.0f;
    int cand[kSlots], child[kSlots], evi[kSlots];
    float pr[kSlots], rank[kSlots];
    bool forbid[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      cand[k] = c < C ? static_cast<int>(cand_r[c]) : -1;
      child[k] = -1;
      evi[k] = 0;
      pr[k] = -1.0f;
      rank[k] = kNoRank;
      forbid[k] = false;
      if (cand[k] >= 0) {
        const long long e = bn * g.a + cand[k];
        child[k] = __ldg(g.children + e);
        evi[k] = g.edge_visits[e];
        pr[k] = __ldg(g.prior + e);
        if (kRank) rank[k] = static_cast<float>(__ldg(g.policy_rank + e));
        if (kForbid) forbid[k] = static_cast<long long>(__ldg(g.avoid_until + arow + cand[k])) > depth;
      }
    }
    // round trip (b): each child's stats row and node fields
    float w[kSlots], lp_visited[kSlots], q_child[kSlots], cvis[kSlots], cw[kSlots], cu[kSlots],
        cusq[kSlots], cself[kSlots];
    int crow[kSlots];
    bool live[kSlots], cterm[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      w[k] = 0.0f;
      lp_visited[k] = 0.0f;
      q_child[k] = 0.0f;
      cvis[k] = 0.0f;
      cw[k] = 0.0f;
      cu[k] = 0.0f;
      cusq[k] = 0.0f;
      cself[k] = 0.0f;
      crow[k] = 0;
      live[k] = false;
      cterm[k] = false;
      if (c >= C) continue;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (child[k] >= 0 && child[k] < g.n) {
        const long long cn = row0 + child[k];
        const float4* r = g.stats + cn * 2;
        lo = __ldg(r);
        hi = __ldg(r + 1);
        cterm[k] = __ldg(g.terminal + cn) != 0;
        crow[k] = cand_row(__ldg(g.last_spot + cn), __ldg(g.last_dir + cn), g.area);
        cself[k] = __ldg(g.self_stats + cn * 4);
      }
      const float ev = static_cast<float>(evi[k]);
      g.cs_raw[(slot + c) * 2] = lo;
      g.cs_raw[(slot + c) * 2 + 1] = hi;
      g.prior_c[slot + c] = pr[k];
      g.child_c[slot + c] = child[k];
      g.ev_c[slot + c] = ev;
      if (kRank) g.rank_c[slot + c] = rank[k];
      // _edge_stats_from_raw: lo = (visits, w, wsq, u)
      cvis[k] = lo.x;
      cw[k] = lo.y;
      cu[k] = lo.w;
      cusq[k] = hi.x;
      const float scale = ev / fmaxf(lo.x, 1.0f);
      live[k] = child[k] >= 0 && ev > 0.0f;
      w[k] = live[k] ? lo.y * scale : 0.0f;
      q_child[k] = -lo.w;
      lp_visited[k] = live[k] ? fmaxf(pr[k], 0.0f) : 0.0f;
    }
    if (term) break;  // the lanes are saved; nothing is recorded

    // _selection_compact
    const float2 sums = torch_row_sums(w, lp_visited, lane, C, width);
    const float total_w = sums.x;
    const float mass = sums.y;

    float factor = 1.0f;
    if (s.stdev_on) {  // _stdev_factor
      const float w_sum = ns_w, u = ns_u;
      const float uu = u * u;
      const float usq = fmaxf(ns_usq, uu);
      const float num = (uu + s.var_prior) * s.stdev_prior_weight + usq * w_sum;
      const float den = s.stdev_prior_weight + fmaxf(w_sum - 1.0f, s.eps);
      float stdev = sqrtf(fmaxf(num / den - uu, 0.0f));
      stdev = w_sum <= 1.0f ? s.stdev_prior : stdev;
      factor = 1.0f + s.stdev_scale * (stdev * s.inv_stdev_prior - 1.0f);
    }
    // _explore_scaling
    const float cpuct =
        s.cpuct + s.cpuct_log * logf((total_w + s.cpuct_base) * s.inv_cpuct_base);
    const float explore = cpuct * sqrtf(total_w + 0.01f) * factor;
    // _fpu_parent_utility
    float parent_u = ns_u;
    if (s.fpu_mode == kFpuVisitedPolicy) {
      const float avg_w = fminf(pow_scalar(mass, s.visited_pow, s.pow_mode), 1.0f);
      parent_u = avg_w * ns_u + (1.0f - avg_w) * self_u;
    } else if (s.fpu_mode == kFpuParentWeight) {
      parent_u = s.fpu_parent_weight * self_u + s.one_minus_fpu_parent_weight * ns_u;
    }
    float fpu = parent_u - s.fpu_reduction_max * sqrtf(mass);
    fpu = fpu + (s.neg_wl_factor - fpu) * s.fpu_loss_prop;

    // _avoid: the mask holds only if some legal lane is left unforbidden
    bool keep = false;
    if (kForbid) {
      bool open = false;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) open |= pr[k] >= 0.0f && !forbid[k];
      keep = __any_sync(kFull, open);
    }

    float best_v = KC_NEG_INF;
    int best_c = INT_MAX;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      if (c >= C) continue;
      const float q = live[k] ? q_child[k] : fpu;
      float v = explore * fmaxf(pr[k], 0.0f) / (1.0f + w[k]) + q;
      v = pr[k] < 0.0f || (forbid[k] && keep) ? KC_NEG_INF : v;
      if (best_c == INT_MAX || v > best_v) {
        best_v = v;
        best_c = c;
      }
    }
    // the warp's best score, then the lowest candidate lane that has it:
    // a lane's own best is its lower lane on ties, and lanes c < 32 come
    // before lanes c >= 32 (a thread with no lane c < C has key 0 and loses;
    // a lane at -inf, illegal or forbidden, has the least key of a score, so
    // where every lane is -inf the first one wins, as in torch.argmax)
    const unsigned key = best_c == INT_MAX ? 0u : score_key(best_v);
    const bool at_top = key == __reduce_max_sync(kFull, key);
    const unsigned low = __ballot_sync(kFull, at_top && best_c < 32);
    best_c = low ? __ffs(low) - 1 : 32 + __ffs(__ballot_sync(kFull, at_top)) - 1;
    // the chosen lane's values, to every lane
    const int sel_slot = best_c >> 5;  // the same in every lane
    const int src = best_c & 31;
#define KC_CHOSEN(x) __shfl_sync(kFull, sel_slot ? (x)[1] : (x)[0], src)
    const int sel_child = KC_CHOSEN(child);
    const int sel_cand = KC_CHOSEN(cand);
    const int sel_evi = KC_CHOSEN(evi);
    const float sel_cvis = KC_CHOSEN(cvis);
    const float next_w = KC_CHOSEN(cw);
    const float next_u = KC_CHOSEN(cu);
    const float next_usq = KC_CHOSEN(cusq);
    const float next_self_u = KC_CHOSEN(cself);
    const int next_row = KC_CHOSEN(crow);
    const bool next_term = __shfl_sync(kFull, static_cast<int>(sel_slot ? cterm[1] : cterm[0]), src) != 0;
#undef KC_CHOSEN

    // graph search's edge-visit catch-up (_want_catch), unless the row's
    // draw leaks through it
    const bool catch_up = s.graph && sel_child >= 0 && static_cast<float>(sel_evi) < sel_cvis - 0.5f &&
                          !(kLeak && u < g.leak_prob);
    const bool move_on = sel_child >= 0 && !catch_up;
    if (lane == 0) {
      g.acts[prow + depth] = best_c;
      if (kRows) g.acts_f[prow + depth] = sel_cand;
      if (move_on) {
        if (!kRows) g.edge_visits[bn * g.a + sel_cand] = sel_evi + 1;
        g.path[prow + depth + 1] = sel_child;
      }
    }
    caught = catch_up;
    if (!move_on) break;
    node = sel_child;
    depth += 1;
    active = depth < g.d;
    mover = 3 - mover;
    term = next_term;
    row = next_row;
    ns_w = next_w;
    ns_u = next_u;
    ns_usq = next_usq;
    self_u = next_self_u;
  }
  if (lane == 0) {
    g.leaf[b] = node;
    g.leaf_depth[b] = depth;
    g.caught[b] = caught ? 1 : 0;
  }
}

}  // namespace

// The argument layout the wrapper must pass: kNumFloats * 10000 +
// kNumInts * 100 + kNumPointers.
extern "C" int kc_descend_layout() { return kNumFloats * 10000 + kNumInts * 100 + kNumPointers; }

using KernelFn = void (*)(Args, Select);

template <bool kRank, bool kForbid>
KernelFn pick_kernel(bool leak, bool rows) {
  return leak ? (rows ? descend_interior_kernel<kRank, kForbid, true, true>
                      : descend_interior_kernel<kRank, kForbid, true, false>)
              : (rows ? descend_interior_kernel<kRank, kForbid, false, true>
                      : descend_interior_kernel<kRank, kForbid, false, false>);
}

// Launches the descent on `stream`; returns the cudaError_t of the launch.
// `cand` holds table_bytes(area, c) bytes, 16-byte aligned. `f` holds the
// kNumFloats Select floats and `i` the kNumInts ints, in struct order. `b`
// is the number of rows and `k` the rows a game; a non-null `acts_f` sets
// the rows flag (acts_f written, edge_visits not) and a non-null `leak_u`
// the leak flag.
extern "C" int kc_descend_interior(
    const void* last_spot, const void* last_dir, const void* terminal, const void* cand,
    const void* children, void* edge_visits, const void* prior, const void* stats,
    const void* self_stats, const void* to_move, const void* policy_rank, const void* avoid_until,
    const void* leak_u, const void* node0, const void* depth0, const void* active0,
    void* path, void* acts, void* acts_f, void* cs_raw, void* prior_c, void* child_c, void* ev_c, void* rank_c,
    void* leaf, void* leaf_depth, void* caught, int b, int n, int a, int c, int d, int area, int k,
    float leak_prob, const float* f, const int* i, void* stream) {
  if (b == 0) return 0;
  if (c < 1 || c >= 32 * kSlots || d < 1 || area < 1 || k < 1 || b % k != 0 ||
      reinterpret_cast<uintptr_t>(cand) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = table_bytes(area, c);
  if (bytes > kMaxTableBytes) return static_cast<int>(cudaErrorInvalidValue);
  const bool leak = leak_u != nullptr, rows = acts_f != nullptr;
  if (!rows && k != 1) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = i[4] ? (i[5] ? pick_kernel<true, true>(leak, rows) : pick_kernel<true, false>(leak, rows))
                               : (i[5] ? pick_kernel<false, true>(leak, rows) : pick_kernel<false, false>(leak, rows));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args g{static_cast<const long long*>(last_spot), static_cast<const long long*>(last_dir),
         static_cast<const unsigned char*>(terminal), static_cast<const short*>(cand),
         static_cast<const int*>(children), static_cast<int*>(edge_visits),
         static_cast<const float*>(prior), static_cast<const float4*>(stats),
         static_cast<const float*>(self_stats), static_cast<const signed char*>(to_move),
         static_cast<const int*>(policy_rank), static_cast<const int*>(avoid_until),
         static_cast<const float*>(leak_u), static_cast<const long long*>(node0),
         static_cast<const long long*>(depth0), static_cast<const unsigned char*>(active0),
         static_cast<long long*>(path), static_cast<long long*>(acts), static_cast<long long*>(acts_f),
         static_cast<float4*>(cs_raw), static_cast<float*>(prior_c),
         static_cast<int*>(child_c), static_cast<float*>(ev_c), static_cast<float*>(rank_c),
         static_cast<long long*>(leaf), static_cast<long long*>(leaf_depth),
         static_cast<unsigned char*>(caught), b, n, a, c, d, area, bytes, k, leak_prob};
  Select s{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
           f[11], f[12], f[13], f[14], f[15], i[0], i[1], i[2], i[3], i[4], i[5]};
  static_assert(sizeof(Select) == (kNumFloats + kNumInts) * 4, "Select layout");
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, bytes, static_cast<cudaStream_t>(stream)>>>(g, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kc_descend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
