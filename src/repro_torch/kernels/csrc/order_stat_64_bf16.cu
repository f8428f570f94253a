// The order-statistic template for a 64-row register capacity,
// bf16 rows (K1) (one translation unit per capacity and type:
// they compile in parallel).
#include "order_stat.cuh"

template RT_OS_LAUNCH(64, __nv_bfloat16, false);
