// coord_stat for 64-row register capacity, __nv_bfloat16 input (one
// translation unit per instance: they compile in parallel).
#include "coord_stat.cuh"

template void coord_stat_launch<64, __nv_bfloat16>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
