// bulyan_coord (K13) for 64-row register capacity, float input (one
// translation unit per capacity and dtype: they compile in parallel).
#include "bulyan_coord.cuh"

template void bulyan_coord_launch<64, float, false>(
    const void*, const float*, const float*, const void*, float*, int,
    long long, long long, int, int, cudaStream_t);
