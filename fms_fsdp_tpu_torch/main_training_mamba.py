"""Mamba2 hybrid pretraining entry point of the port.

Counterpart of ``main_training_mamba.py`` at the repo root: the Llama
entry with the model swapped. ``get_model_config("mamba_9.8b")`` returns a
``MambaConfig`` and the train-step factory dispatches to the Mamba2 hybrid
forward (``models/mamba.py``), whose SSD scan runs the fused CUDA kernel
on the card (``--mamba_kernel=xla`` runs the chunked einsums). The same
command line runs both packages:

    python -m fms_fsdp_tpu_torch.main_training_mamba \\
        --MambaConfig.n_layer=6 "--MambaConfig.attn_layer_idx=(3,)" \\
        --use_dummy_dataset=True --batch_size=2 --seq_length=4096 \\
        --fsdp_activation_checkpointing=True --selective_checkpointing=0.5 \\
        --num_steps=16 --report_interval=4

It runs on ``cuda`` unless ``device="cpu"`` is passed to :func:`main`
(``--device=cpu``), and raises without a card. The observability and
resilience options, and the data-parallel ones under ``torchrun``
(``--sharding_strategy``), are the Llama entry's.
"""

import sys

from fms_fsdp_tpu_torch.main_training_llama import main as _shared_main
from fms_fsdp_tpu_torch.resilience.exits import classified_exit
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args


def main(device=None, **kwargs):
    kwargs.setdefault("model_variant", "mamba_9.8b")
    kwargs.setdefault("vocab_size", 128256)
    return _shared_main(device=device, **kwargs)


if __name__ == "__main__":
    # classified-exit mapping for the supervisor, as in the Llama entry
    with classified_exit():
        main(**parse_cli_args(sys.argv[1:]))
