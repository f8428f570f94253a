// The scaled coordinate statistic (K18 and K19) for a 32-row register
// capacity, fp8 e4m3 codes (one translation unit per capacity and code
// type: they compile in parallel).
#include "scaled_coord_stat.cuh"

template RT_SCS_LAUNCH(32, __nv_fp8_e4m3, false);
template RT_SCS_LAUNCH(32, __nv_fp8_e4m3, true);
