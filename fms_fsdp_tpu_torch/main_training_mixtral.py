"""Mixtral sparse-MoE pretraining entry point of the port.

Counterpart of ``main_training_mixtral.py`` at the repo root: the Llama
entry with the model swapped. ``get_model_config("mixtral_8x7b")``
returns a ``MixtralConfig`` and the train-step factory dispatches to the
MoE forward (``models/mixtral.py``) with capacity-based dispatch, the
load-balancing term in the objective and ``moe_drop_frac`` in the report
lines and the records' ``extra`` map; attention runs the flash CUDA
kernels on the card. MFU counts the activated experts only. One card
holds the full width at a cut depth:

    python -m fms_fsdp_tpu_torch.main_training_mixtral \\
        --MixtralConfig.nlayers=2 --use_dummy_dataset=True --batch_size=1 \\
        --seq_length=4096 --fsdp_activation_checkpointing=True \\
        --selective_checkpointing=0.5 --num_steps=6 --report_interval=2

It runs on ``cuda`` unless ``device="cpu"`` is passed to :func:`main`
(``--device=cpu``), and raises without a card. The checkpoint,
observability, resilience, data-parallel and long-context options are
the Llama entry's: under ``--context_parallel_size=cp`` the context peers
read one data index's rows and each trains its S / cp chunk, with the
capacity routing of the whole sequence (``models/mixtral.py::
context_slots``). Under ``--expert_parallel_size=ep`` each rank holds E / ep
of every layer's experts and its own rows, and the routed tokens move to
their experts' ranks and back by an all-to-all (``models/mixtral.py::
_moe_ffn_dispatch_a2a``); it composes with fsdp/hsdp/ddp, the tensor and
context axes and the slices, and the mesh line prints ``'expert': ep``.
"""

import sys

from fms_fsdp_tpu_torch.main_training_llama import main as _shared_main
from fms_fsdp_tpu_torch.resilience.exits import classified_exit
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args


def main(device=None, **kwargs):
    kwargs.setdefault("model_variant", "mixtral_8x7b")
    kwargs.setdefault("vocab_size", 32000)
    return _shared_main(device=device, **kwargs)


if __name__ == "__main__":
    # classified-exit mapping for the supervisor, as in the Llama entry
    with classified_exit():
        main(**parse_cli_args(sys.argv[1:]))
