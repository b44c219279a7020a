"""Dreamer-V3 (mirrors ``sheeprl_tpu/algos/dreamer_v3``): the observe+act path."""
