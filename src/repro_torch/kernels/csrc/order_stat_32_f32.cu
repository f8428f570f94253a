// The order-statistic template for a 32-row register capacity,
// fp32 rows (K1) (one translation unit per capacity and type:
// they compile in parallel).
#include "order_stat.cuh"

template RT_OS_LAUNCH(32, float, false);
