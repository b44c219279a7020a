"""Environments of the port (mirrors ``sheeprl_tpu/envs``), with no gymnasium."""
