// coord_stat for 64-row register capacity, float input (one
// translation unit per instance: they compile in parallel).
#include "coord_stat.cuh"

template void coord_stat_launch<64, float>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
