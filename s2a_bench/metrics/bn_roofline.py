"""BatchNorm sums, normalise, gradient sums and dx of the backbone's 53 layers: their bytes bound a step at 3.35 TB/s over their device time, in %."""
from s2a_bench.readers import bn_roofline as read  # noqa: F401
