"""Llama pretraining entry point of the port.

Counterpart of ``main_training_llama.py`` at the repo root, in the same
order — config -> seed -> model -> dataloader -> train state -> LR
schedule -> train — on one card, without the mesh, elastic resume or a
checkpoint load (ROADMAP.md A.5, A.6). The same command line runs both:

    python -m fms_fsdp_tpu_torch.main_training_llama \\
        --model_variant=llama3_8b_4k --LlamaConfig.nlayers=8 \\
        --use_dummy_dataset=True --batch_size=2 --seq_length=4096 \\
        --vocab_size=128256 --fsdp_activation_checkpointing=True \\
        --selective_checkpointing=0.5 --num_steps=12 --report_interval=4

It runs on ``cuda`` unless ``device="cpu"`` is passed to :func:`main`,
and raises without a card. Options not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

import sys

import torch

from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.data.loader import get_dummy_loader
from fms_fsdp_tpu_torch.train.step import (
    check_supported,
    init_train_state,
    make_train_step,
)
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from fms_fsdp_tpu_torch.utils.device import resolve_device
from fms_fsdp_tpu_torch.utils.train_utils import train


def main(device=None, **kwargs):
    """Train per ``TrainConfig`` overrides in ``kwargs``. Returns the
    loop's summary (``utils/train_utils.py::train``) with the final train
    state and the resolved configs under "state", "cfg" and "model_cfg"."""
    cfg = TrainConfig()
    update_config(cfg, **kwargs)
    device = resolve_device(device)
    check_supported(cfg)
    print(f"--> running with these configs {cfg}")

    # model config; dotted CLI overrides (LlamaConfig.param=value) apply here
    model_cfg = get_model_config(cfg.model_variant)
    update_config(model_cfg, **kwargs)
    print(f"\n--> model has {model_cfg.n_params() / 1e6} Million params\n")

    print("Constructing datasets...")
    loader = get_dummy_loader(cfg, 0, 1)
    print("Datasets constructed!")

    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_train_state(generator, model_cfg, cfg)
    step_fn = make_train_step(model_cfg, cfg)

    print(f"Training for {cfg.num_steps} steps")
    summary = train(cfg, state, step_fn, 0, iter(DeviceFeed(loader, device)),
                    model_cfg=model_cfg, device=device)
    return dict(summary, state=state, cfg=cfg, model_cfg=model_cfg)


if __name__ == "__main__":
    main(**parse_cli_args(sys.argv[1:]))
