"""``python -m sheeprl_tpu_torch.cli_agents``: print the registered
algorithms (port of ``sheeprl_tpu/cli_agents.py``)."""

from sheeprl_tpu_torch.cli import available_agents

if __name__ == "__main__":
    available_agents()
