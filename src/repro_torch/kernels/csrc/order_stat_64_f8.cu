// The order-statistic template for a 64-row register capacity,
// fp8 e4m3 codes (K18 and K19) (one translation unit per capacity and type:
// they compile in parallel).
#include "order_stat.cuh"

template RT_OS_LAUNCH(64, __nv_fp8_e4m3, false);
template RT_OS_LAUNCH(64, __nv_fp8_e4m3, true);
