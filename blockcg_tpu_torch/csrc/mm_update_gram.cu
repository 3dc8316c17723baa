// Y = M B (+ A) on lanes-major (k, n) fields, with the Gram G = Y Y^T of the
// stored Y, in one pass over B; without the Gram (G == nullptr), also the
// row chunks of mm_update above 128 rows.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py mm_update_gram. The
// kernel is update_gram.cuh's streaming update on one input field, A added in
// each tile's epilogue, and on bf16 fields with the fused Gram (k <= 64) its
// tensor-core update_gram_mma (their designs, bounds and arithmetic are
// described there).
#include "update_gram.cuh"

// Y (k, n) = M B (+ A) with M k x kin (row stride kin), B (kin, n), A (k, n)
// or nullptr; G (k x k) = Y Y^T when G != nullptr (k <= 96), part then holds
// (max_blocks, k, k) and the launch uses at most max_blocks blocks. kc: input
// rows a stage copies (ops/fused.py update_plan). Y may equal B when k ==
// kin, or A.
template <typename E>
int mm_update_gram_entry(const float* M, const E* B, const E* A, E* Y, float* part, float* G,
                         int k, int kin, long long n, int kc, int max_blocks, int device,
                         cudaStream_t stream) {
  return A ? dispatch<E, 1, true>(M, B, nullptr, nullptr, A, Y, part, G, k, kin, n, kc,
                                  max_blocks, device, stream)
           : dispatch<E, 1, false>(M, B, nullptr, nullptr, nullptr, Y, part, G, k, kin, n, kc,
                                   max_blocks, device, stream);
}

extern "C" int bcg_mm_update_gram(const float* M, const float* B, const float* A, float* Y,
                                  float* part, float* G, int k, int kin, long long n, int kc,
                                  int max_blocks, int device, cudaStream_t stream) {
  return mm_update_gram_entry(M, B, A, Y, part, G, k, kin, n, kc, max_blocks, device, stream);
}

// The same on bf16 fields B, A and Y, M f32 (held exactly: f32 FMAs on the
// lifted fields), without the fused Gram (G == nullptr) or above 64 rows;
// G is f32, of the stored bf16 Y. The fused Gram up to 64 rows runs
// bcg_mm_update_gram_mma.
extern "C" int bcg_mm_update_gram_bf16(const float* M, const bf16* B, const bf16* A, bf16* Y,
                                       float* part, float* G, int k, int kin, long long n,
                                       int kc, int max_blocks, int device,
                                       cudaStream_t stream) {
  return mm_update_gram_entry(M, B, A, Y, part, G, k, kin, n, kc, max_blocks, device, stream);
}

// The same on bf16 fields on the tensor cores with the fused Gram
// (update_gram.cuh update_gram_mma), k <= 64: M f32 k x k, split exactly
// into three bf16 pieces; G = Y Y^T of the stored bf16 Y, exactly
// symmetric. T and stages come from ops/fused.py update_gram_mma_plan;
// part holds (max_blocks, k, k). Y may equal B or A.
extern "C" int bcg_mm_update_gram_mma(const float* M, const bf16* B, const bf16* A, bf16* Y,
                                      float* part, float* G, int k, long long n, int T,
                                      int stages, int max_blocks, int device,
                                      cudaStream_t stream) {
  return dispatch_mma<1>(M, B, nullptr, nullptr, A, Y, part, G, k, n, T, stages, max_blocks,
                         device, stream);
}
