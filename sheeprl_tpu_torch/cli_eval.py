"""``python -m sheeprl_tpu_torch.cli_eval checkpoint_path=...`` (port of
``sheeprl_tpu/cli_eval.py``)."""

from sheeprl_tpu_torch.cli import evaluation

if __name__ == "__main__":
    evaluation()
