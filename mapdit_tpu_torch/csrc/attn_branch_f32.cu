// attn_branch_f32: the f32 instances of attn_branch.cu's kernels (rows 3, 5
// and 4 of a float32 model) and their entry points, attn_branch_fwd_f32,
// attn_branch_res_fwd_f32, attn_branch_bwd_f32 and
// attn_branch_f32_resident_ctas. A library of its own, so that nvcc builds
// it beside the bf16 instances, at the same time.
#define ATTN_BRANCH_F32 1
#include "attn_branch.cu"
