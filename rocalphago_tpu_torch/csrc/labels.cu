// Batched connected-component labelling of Go boards.
//
// Replaces the TPU kernel rocalphago_tpu/ops/labels.py::pallas_labels
// (body _label_kernel): every point gets the minimum flat index of its
// same-colour 4-connected group, empty points get N = size * size.
// A board point holds 0 (empty) or a colour: any value > 0 is one
// colour, any value < 0 the other. Game boards hold -1, 0 and +1; area
// scoring labels its empty regions on boards of 9 (empty) and 0.
//
// What bounds it on an H100: neither bytes nor operations. A 19x19
// board is 361 bytes in and 1,444 bytes out, and an iteration is a
// handful of integer ops per point; what costs is the chain of
// dependent iterations, and at one board the launch and the first
// fetch of the kernel's code. The design keeps a board in one warp's
// registers and needs no barrier and no shared memory:
//
// - One warp per board, kBoardsPerBlock = 4 boards per block (one
//   board on each of an SM's schedulers); a converged board's warp
//   exits without waiting for the others.
// - Thread r holds row r: its colours as two bitboards and its `size`
//   labels in registers (size is a template parameter, so the row
//   arrays unroll; 9, 13, 19 and 25 are instantiated, and a generic
//   instance takes any size <= 32).
// - An iteration is a forward and then a backward min-scan along the
//   row through runs of the same colour, which settles every row
//   segment in one pass, then one vertical exchange of each column's
//   label with the rows above and below (__shfl_up_sync and
//   __shfl_down_sync), keeping the minimum where the vertical
//   neighbour has the same colour. __any_sync of "changed" ends it.
//   So the iterations a board needs are about the number of vertical
//   steps a group's minimum has to travel (2 to 8 on the boards of a
//   game, one per row on a serpentine).
//
// Exactness: a point's label is always the index of a stone of its own
// group (the scans and the exchange take a linked neighbour's label),
// labels only decrease, and the group's minimum point never changes its
// own label; so an iteration with no change anywhere in the warp is the
// unique fixpoint, whatever order the updates ran in. N iterations
// bound the loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBoardsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(kBoardsPerBlock * 32)
labels_kernel(const int8_t* __restrict__ boards, int32_t* __restrict__ out,
              int batch, int size_arg) {
  constexpr int W = S > 0 ? S : 32;
  const int size = S > 0 ? S : size_arg;
  const int n = size * size;
  const int board = blockIdx.x * kBoardsPerBlock + (threadIdx.x >> 5);
  if (board >= batch) return;  // the whole warp
  const int row = threadIdx.x & 31;
  const bool live = row < size;
  const size_t off = static_cast<size_t>(board) * n +
                     static_cast<size_t>(live ? row : 0) * size;

  uint32_t bk = 0, wt = 0;
  int lab[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    lab[c] = n;
    if (live && (S > 0 || c < size)) {
      const int v = boards[off + c];
      bk |= static_cast<uint32_t>(v > 0) << c;
      wt |= static_cast<uint32_t>(v < 0) << c;
      if (v != 0) lab[c] = row * size + c;
    }
  }
  // links: bit c of `right` joins (row, c) and (row, c + 1); bit c of
  // `up`/`down` joins (row, c) and the same column one row up/down
  const uint32_t right = (bk & bk >> 1) | (wt & wt >> 1);
  uint32_t bk_up = __shfl_up_sync(kFull, bk, 1);
  uint32_t wt_up = __shfl_up_sync(kFull, wt, 1);
  uint32_t bk_dn = __shfl_down_sync(kFull, bk, 1);
  uint32_t wt_dn = __shfl_down_sync(kFull, wt, 1);
  if (row == 0) bk_up = wt_up = 0;
  if (row == 31) bk_dn = wt_dn = 0;
  const uint32_t up = (bk & bk_up) | (wt & wt_up);
  const uint32_t down = (bk & bk_dn) | (wt & wt_dn);

  for (int it = 0; it < n; ++it) {
    bool changed = false;
#pragma unroll
    for (int c = 1; c < W; ++c) {
      if ((right >> (c - 1)) & 1u) {
        const int v = min(lab[c], lab[c - 1]);
        changed |= v != lab[c];
        lab[c] = v;
      }
    }
#pragma unroll
    for (int c = W - 2; c >= 0; --c) {
      if ((right >> c) & 1u) {
        const int v = min(lab[c], lab[c + 1]);
        changed |= v != lab[c];
        lab[c] = v;
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int from_up = __shfl_up_sync(kFull, lab[c], 1);
      const int from_dn = __shfl_down_sync(kFull, lab[c], 1);
      int v = lab[c];
      if ((up >> c) & 1u) v = min(v, from_up);
      if ((down >> c) & 1u) v = min(v, from_dn);
      changed |= v != lab[c];
      lab[c] = v;
    }
    if (!__any_sync(kFull, changed)) break;
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (S > 0 || c < size) out[off + c] = lab[c];
  }
}

template <int S>
void launch(const void* boards, void* out, int batch, int size,
            cudaStream_t stream) {
  const int blocks = (batch + kBoardsPerBlock - 1) / kBoardsPerBlock;
  labels_kernel<S><<<blocks, kBoardsPerBlock * 32, 0, stream>>>(
      static_cast<const int8_t*>(boards), static_cast<int32_t*>(out), batch,
      size);
}

}  // namespace

// boards: int8 [batch, size*size]; out: int32 [batch, size*size];
// size <= 32. Returns the CUDA error of the launch (0 on success).
extern "C" int rocalphago_labels(const void* boards, void* out, int batch,
                                 int size, void* stream) {
  if (batch <= 0 || size <= 0 || size > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 9: launch<9>(boards, out, batch, size, st); break;
    case 13: launch<13>(boards, out, batch, size, st); break;
    case 19: launch<19>(boards, out, batch, size, st); break;
    case 25: launch<25>(boards, out, batch, size, st); break;
    default: launch<0>(boards, out, batch, size, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
