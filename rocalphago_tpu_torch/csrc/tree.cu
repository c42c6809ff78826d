// The two tree walks of the on-device PUCT search: descend and backup.
//
// Not a port of a Pallas kernel. These replace the two data-dependent
// lax.while_loops of rocalphago_tpu/search/device_mcts.py:
// _descend_one (with the PUCT rule of _select_action) and _backup_one.
// In eager PyTorch each level of such a loop would be a device->host
// sync to test whether every game has stopped; a kernel keeps the whole
// walk on the card, so a chunk of simulations runs without the host.
//
// Layout: per game b a slab of M nodes; edge rows of A = N + 1 actions:
// prior f32, visits i32, value_sum f32 and child i32 are [B, M, A];
// done (bool) is [B, M]; parent and paction i32 [B, M].
//
// What bounds it on an H100: neither bytes nor operations. A level of
// the descent reads one node's edge rows (12 bytes an edge, 4.3 KB at
// 19x19) and does a dozen float operations an edge; what costs is the
// chain of dependent levels (the child pointer read at one level is the
// address of the next), each a row read, a warp reduction and a warp
// argmax. The design:
//
// - descend: one warp per game, kGamesPerBlock = 4 games per block. At
//   each level the lanes stride over the edges: one pass sums the
//   visits (an integer sum, exact; as a float it equals the reference's
//   float32 sum below 2**24 in any order), a second scores every edge
//   and keeps its best; a butterfly of shuffles then takes the warp's
//   argmax, ties to the lowest index as jnp.argmax does. Every lane
//   ends with the same action and follows the same child pointer, so
//   the warp never diverges between levels.
// - backup: one thread per game walks parent/paction up to the root,
//   adding one visit and +-v (the sign alternating at each level) to
//   each edge on the way. It is a chain of dependent loads; games are
//   independent, so a block of threads runs many at once.
//
// Exactness: the score is written with round-to-nearest intrinsics
// (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn), so nvcc cannot
// contract a product and a sum into an FMA, in the order the reference
// is compiled to: p * (sqrt(n + 1) * c_puct) / (1 + n_a) plus q (XLA
// gathers the two per-node scalars of c_puct * p * sqrt(n + 1) first).
// The backup's float add is __fadd_rn too. Both walks are bounded by M levels (a slab of M nodes
// is a tree, so no walk is longer).
//
// Forced playouts (forced_k > 0, the reference's _select_action_root):
// at the root of a free descent, the pass that scores the edges also
// keeps the largest deficit floor - n_a over prior-supported edges,
// floor = sqrt(p * (N * forced_k)) (N the root's visit total; the order
// XLA compiles sqrt(forced_k * p * N) to), and a second butterfly takes
// its argmax, ties to the lowest index. A positive deficit wins over
// PUCT. Every lane holds the same node, so the root test is uniform
// across the warp; at forced_k = 0 the deficit is never computed and
// the walk is the plain PUCT walk.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGamesPerBlock = 4;
constexpr int kBackupThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfBits = 0xff800000u;

__global__ void __launch_bounds__(kGamesPerBlock * 32)
descend_kernel(const float* __restrict__ prior,
               const int32_t* __restrict__ visits,
               const float* __restrict__ value_sum,
               const int32_t* __restrict__ child,
               const bool* __restrict__ done,
               const int32_t* __restrict__ root,
               const int32_t* __restrict__ root_action,
               int32_t* __restrict__ node_out,
               int32_t* __restrict__ action_out, int batch, int max_nodes,
               int num_actions, float c_puct, float forced_k) {
  const int b = blockIdx.x * kGamesPerBlock + (threadIdx.x >> 5);
  if (b >= batch) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t A = static_cast<size_t>(num_actions);
  const size_t slab = static_cast<size_t>(b) * max_nodes * A;
  const float* P = prior + slab;
  const int32_t* V = visits + slab;
  const float* W = value_sum + slab;
  const int32_t* C = child + slab;
  const bool* D = done + static_cast<size_t>(b) * max_nodes;

  // the root step: a terminal root is the leaf itself; a forced first
  // edge (root_action >= 0) is taken without selection
  const int root_node = root[b];
  int node = root_node;
  int action = -1;
  const int ra = root_action[b];
  bool stop = D[node];
  if (!stop && ra >= 0) {
    action = ra;
    const int nxt = C[node * A + ra];
    if (nxt < 0) {
      stop = true;
    } else {
      node = nxt;
    }
  }
  for (int level = 0; !stop && level < max_nodes; ++level) {
    if (D[node]) {
      action = -1;
      break;
    }
    const size_t row = node * A;
    int total = 0;
    for (int a = lane; a < num_actions; a += 32) total += V[row + a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(kFull, total, off);
    const float cs = __fmul_rn(
        __fsqrt_rn(__fadd_rn(static_cast<float>(total), 1.0f)), c_puct);
    const float neg_inf = __int_as_float(kNegInfBits);
    // forced playouts: only at the root, only when asked (warp-uniform)
    const bool floors = forced_k > 0.0f && node == root_node;
    const float nk = __fmul_rn(static_cast<float>(total), forced_k);
    float best = neg_inf;
    int best_a = INT_MAX;
    float best_d = neg_inf;
    int best_da = INT_MAX;
    for (int a = lane; a < num_actions; a += 32) {
      const float p = P[row + a];
      const int v = V[row + a];
      const float nv = static_cast<float>(v);
      const float q = v > 0 ? __fdiv_rn(W[row + a], fmaxf(nv, 1.0f)) : 0.0f;
      const float u = __fdiv_rn(__fmul_rn(p, cs), __fadd_rn(1.0f, nv));
      const float score = p > 0.0f ? __fadd_rn(q, u) : neg_inf;
      if (score > best || (score == best && a < best_a)) {
        best = score;
        best_a = a;
      }
      if (floors) {
        const float d =
            p > 0.0f ? __fsub_rn(__fsqrt_rn(__fmul_rn(p, nk)), nv) : neg_inf;
        if (d > best_d || (d == best_d && a < best_da)) {
          best_d = d;
          best_da = a;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oa = __shfl_xor_sync(kFull, best_a, off);
      if (ob > best || (ob == best && oa < best_a)) {
        best = ob;
        best_a = oa;
      }
    }
    if (floors) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, best_d, off);
        const int oa = __shfl_xor_sync(kFull, best_da, off);
        if (od > best_d || (od == best_d && oa < best_da)) {
          best_d = od;
          best_da = oa;
        }
      }
    }
    action = floors && best_d > 0.0f ? best_da : best_a;
    const int nxt = C[row + action];
    if (nxt < 0) break;
    node = nxt;
  }
  if (lane == 0) {
    node_out[b] = node;
    action_out[b] = action;
  }
}

__global__ void __launch_bounds__(kBackupThreads)
backup_kernel(int32_t* __restrict__ visits, float* __restrict__ value_sum,
              const int32_t* __restrict__ parent,
              const int32_t* __restrict__ paction,
              const int32_t* __restrict__ start_node,
              const int32_t* __restrict__ start_action,
              const float* __restrict__ values, int batch, int max_nodes,
              int num_actions) {
  const int b = blockIdx.x * kBackupThreads + threadIdx.x;
  if (b >= batch) return;
  const size_t A = static_cast<size_t>(num_actions);
  const size_t slab = static_cast<size_t>(b) * max_nodes * A;
  int32_t* V = visits + slab;
  float* W = value_sum + slab;
  const int32_t* par = parent + static_cast<size_t>(b) * max_nodes;
  const int32_t* pac = paction + static_cast<size_t>(b) * max_nodes;
  int node = start_node[b];
  int action = start_action[b];
  float v = -values[b];
  for (int level = 0; node >= 0 && level < max_nodes; ++level) {
    const size_t e = node * A + action;
    V[e] += 1;
    W[e] = __fadd_rn(W[e], v);
    action = pac[node];
    node = par[node];
    v = -v;
  }
}

}  // namespace

// prior f32, visits i32, value_sum f32, child i32: [batch, max_nodes,
// num_actions]; done bool [batch, max_nodes]; root, root_action (-1 =
// free) i32 [batch]; forced_k > 0 turns on forced playouts at the root.
// Writes node_out and action_out (-1 = the walk ended on a terminal
// node) i32 [batch]. Returns the CUDA error of the launch (0 on
// success).
extern "C" int rocalphago_tree_descend(
    const void* prior, const void* visits, const void* value_sum,
    const void* child, const void* done, const void* root,
    const void* root_action, void* node_out, void* action_out, int batch,
    int max_nodes, int num_actions, float c_puct, float forced_k,
    void* stream) {
  if (batch <= 0 || max_nodes <= 0 || num_actions <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kGamesPerBlock - 1) / kGamesPerBlock;
  descend_kernel<<<blocks, kGamesPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prior), static_cast<const int32_t*>(visits),
      static_cast<const float*>(value_sum),
      static_cast<const int32_t*>(child), static_cast<const bool*>(done),
      static_cast<const int32_t*>(root),
      static_cast<const int32_t*>(root_action),
      static_cast<int32_t*>(node_out), static_cast<int32_t*>(action_out),
      batch, max_nodes, num_actions, c_puct, forced_k);
  return static_cast<int>(cudaGetLastError());
}

// visits i32 and value_sum f32 [batch, max_nodes, num_actions], updated
// in place; parent, paction i32 [batch, max_nodes]; start_node (-1 =
// nothing to back up), start_action i32 and values f32 [batch]. Returns
// the CUDA error of the launch (0 on success).
extern "C" int rocalphago_tree_backup(
    void* visits, void* value_sum, const void* parent, const void* paction,
    const void* start_node, const void* start_action, const void* values,
    int batch, int max_nodes, int num_actions, void* stream) {
  if (batch <= 0 || max_nodes <= 0 || num_actions <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kBackupThreads - 1) / kBackupThreads;
  backup_kernel<<<blocks, kBackupThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(visits), static_cast<float*>(value_sum),
      static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(paction),
      static_cast<const int32_t*>(start_node),
      static_cast<const int32_t*>(start_action),
      static_cast<const float*>(values), batch, max_nodes, num_actions);
  return static_cast<int>(cudaGetLastError());
}
