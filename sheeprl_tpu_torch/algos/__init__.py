"""Algorithms of the port (mirrors ``sheeprl_tpu/algos``)."""
