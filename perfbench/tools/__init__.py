"""Tools beside the benchmark: the calibration of its limits."""
