"""Network blocks of the port (mirrors ``sheeprl_tpu/models``)."""
