// Batched connected-component labelling of Go boards.
//
// Replaces the TPU kernel rocalphago_tpu/ops/labels.py::pallas_labels
// (body _label_kernel): every point gets the minimum flat index of its
// same-colour 4-connected group, empty points get N = size * size.
//
// What bounds it on an H100: neither bytes nor operations. A 19x19
// board is 361 bytes in and 1,444 bytes out, and a fixpoint sweep is a
// handful of integer ops per point; what costs is the number of
// dependent sweeps and the block-wide barrier behind each. The design
// keeps every sweep in shared memory (one block per board, one thread
// per point, no device-memory traffic between sweeps) and cuts the
// sweep count with pointer jumping: after each hook step a point
// adopts the label of its current label's point, so long snake groups
// converge in O(log N) sweeps instead of O(diameter). The TPU kernel
// left the jump out only because its vector units have no fast gather.
//
// Exactness: a point's label is always the index of a stone of its own
// group (hooks take a linked neighbour's label, jumps follow labels),
// labels only decrease, and the group's minimum point never changes its
// own label; so a sweep with no change anywhere, tested block-wide with
// __syncthreads_or, is the unique fixpoint. N sweeps bound the loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void labels_kernel(const int8_t* __restrict__ boards,
                              int32_t* __restrict__ out, int size) {
  extern __shared__ int32_t smem[];
  const int n = size * size;
  int32_t* lab = smem;
  int8_t* bd = reinterpret_cast<int8_t*>(smem + n);
  const int p = threadIdx.x;
  const bool live = p < n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  int8_t c = 0;
  if (live) {
    c = boards[base + p];
    bd[p] = c;
    lab[p] = c != 0 ? p : n;
  }
  __syncthreads();

  // same-colour neighbours, fixed for the whole fill
  int nb[4];
  int k = 0;
  if (live && c != 0) {
    const int x = p / size, y = p % size;
    if (x + 1 < size && bd[p + size] == c) nb[k++] = p + size;
    if (x > 0 && bd[p - size] == c) nb[k++] = p - size;
    if (y + 1 < size && bd[p + 1] == c) nb[k++] = p + 1;
    if (y > 0 && bd[p - 1] == c) nb[k++] = p - 1;
  }

  for (int sweep = 0; sweep < n; ++sweep) {
    const int old = live ? lab[p] : n;
    int v = old;
    for (int j = 0; j < k; ++j) v = min(v, lab[nb[j]]);  // hook
    __syncthreads();
    if (live) lab[p] = v;
    __syncthreads();
    if (v < n) v = min(v, lab[v]);                        // jump
    __syncthreads();
    if (live) lab[p] = v;
    if (!__syncthreads_or(v != old)) break;
  }
  if (live) out[base + p] = lab[p];
}

}  // namespace

// boards: int8 [batch, size*size]; out: int32 [batch, size*size].
// Returns the CUDA error of the launch (0 on success).
extern "C" int rocalphago_labels(const void* boards, void* out, int batch,
                                 int size, void* stream) {
  const int n = size * size;
  const int threads = (n + 31) / 32 * 32;
  if (batch <= 0 || size <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = n * sizeof(int32_t) + n;
  labels_kernel<<<batch, threads, shmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards), static_cast<int32_t*>(out), size);
  return static_cast<int>(cudaGetLastError());
}
