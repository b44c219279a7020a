"""``python -m sheeprl_tpu_torch exp=... overrides`` (port of
``sheeprl_tpu/__main__.py``)."""

from sheeprl_tpu_torch.cli import run

if __name__ == "__main__":
    run()
