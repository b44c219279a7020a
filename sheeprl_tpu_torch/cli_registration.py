"""``python -m sheeprl_tpu_torch.cli_registration checkpoint_path=...``:
register a checkpoint's models with the model manager (port of
``sheeprl_tpu/cli_registration.py``)."""

from sheeprl_tpu_torch.cli import registration

if __name__ == "__main__":
    registration()
