// Paged GQA attention on bf16 pages: the exports paged_decode_bf16,
// paged_pool_decode_bf16, paged_chunk_bf16 and paged_pool_chunk_bf16,
// the kernels of paged_attention.cu instantiated at T = __nv_bfloat16
// (unquantized).  A source of its own so that nvcc builds it beside
// paged_attention.cu; the decode form's merge of its split partials is
// this library's copy of paged_combine_f32's kernel.
#define PAGED_BF16
#include "paged_attention.cu"
