"""Speculator training entry point of the port.

Counterpart of ``speculator/train_speculator.py`` at the repo root
(ref:speculator/train_speculator.py:107-326), in the same order: config
-> process group -> frozen base model -> sanity generation -> MLP
speculator (replicated) -> dataloader (raw packed sequences, no causal
shift) -> checkpoint manager and load -> two-stage training loop.

The frozen base comes from one of three sources:

- an HF checkpoint directory at ``model_path`` (Llama, GPTBigCode or
  Mixtral: ``models/hf_import.py::load_hf_base``), whose architecture
  overrides ``model_arch`` and whose config is the base's;
- a checkpoint the port's trainers wrote at ``model_path`` (a params
  pickle, a ``step_N_ckp`` dir or a ``checkpoints/`` root): its params,
  read as ``ServingEngine.from_checkpoint`` reads them;
- else a random bf16 init from ``seed`` (smoke-test mode), with
  ``GPTBigCodeConfig()`` / ``MixtralConfig()`` defaults for the
  non-Llama architectures.

In the last two the model config comes from ``model_variant`` (Llama) or
those defaults, with the dotted overrides (``--GPTBigCodeConfig.nlayers``)
applied. The base's params are bf16 on the device in every case.

On a card, at llama3_8b width and depth:

    python -m fms_fsdp_tpu_torch.speculator.train_speculator \\
        --model_variant=llama3_8b --use_dummy_dataset=True \\
        --vocab_size=128256 --batch_size=2 --seq_length=4096 \\
        --num_steps=8 --stage2_start_step=6 --stage2_batch_size=32 \\
        --stage2_seq_length=64 --report_interval=1 --ckpt_save_path=CK

and on the CPU with a TINY base (``--device=cpu``):

    python -m fms_fsdp_tpu_torch.speculator.train_speculator --device=cpu \\
        --LlamaConfig.nlayers=2 --LlamaConfig.emb_dim=64 \\
        --LlamaConfig.nheads=4 --LlamaConfig.kvheads=2 \\
        --LlamaConfig.src_vocab_size=128 --vocab_size=128 \\
        --speculator_width=32 --use_dummy_dataset=True --batch_size=2 \\
        --seq_length=64 --num_steps=4 --stage2_start_step=2 \\
        --stage2_batch_size=4 --stage2_prompt_length=8 \\
        --stage2_seq_length=16 --report_interval=1 --ckpt_save_path=CK

``seq_length`` grows by ``n_speculator_heads + 1`` (room for every
head's ground truth). ``main`` writes a final checkpoint at
``num_steps`` and resumes from ``ckpt_save_path``; its fingerprint names
the speculator and its base arch, so a pretraining checkpoint is never
resumed as one. It runs on ``cuda`` unless ``device="cpu"`` is passed,
and raises without a card.
"""

import os
import sys
import time

import numpy as np
import torch

from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
from fms_fsdp_tpu_torch.ckpt.elastic import current_fingerprint
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.data.loader import get_data_loader, get_dummy_loader, rebatch
from fms_fsdp_tpu_torch.models import get_base_api
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.models.gpt_bigcode import GPTBigCodeConfig
from fms_fsdp_tpu_torch.models.hf_import import is_hf_checkpoint, load_hf_base
from fms_fsdp_tpu_torch.models.speculator import SpeculatorConfig, init_speculator_params
from fms_fsdp_tpu_torch.obs import build_observer
from fms_fsdp_tpu_torch.resilience.exits import classified_exit
from fms_fsdp_tpu_torch.train.speculator import (
    base_device,
    check_speculator_options,
    speculator_state,
    train_speculator,
)
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from fms_fsdp_tpu_torch.utils.device import resolve_device
from fms_fsdp_tpu_torch.utils.dist import init_distributed
from fms_fsdp_tpu_torch.utils.train_utils import get_profiler
from fms_fsdp_tpu_torch.utils.tree import tree_map


def test_model(rank, base_params, model_cfg, base_api):
    """Sanity generation on the loaded base
    (ref:speculator/train_speculator.py:34-60 analog)."""
    device = base_device(base_params)
    prompt = (torch.arange(16, device=device) % model_cfg.src_vocab_size)[None, :]
    out = base_api.generate(
        base_params, prompt, model_cfg, generator=None, max_seq_len=64,
        max_new_tokens=8, do_sample=False, include_embeds=False,
    )
    if rank == 0:
        print(f"{time.time()} sanity generation:", np.asarray(out[0, -8:].cpu()))


def _as_batches(loader):
    """The feed stages a tuple per batch: wrap raw (B, L) arrays."""
    for batch in loader:
        yield batch if isinstance(batch, tuple) else (batch,)


def load_hf(cfg, base_api, device, rank):
    """The HF base at ``model_path``: (base_api, model_cfg, params in bf16
    on ``device``). Its architecture overrides ``model_arch``."""
    arch, model_cfg, params = load_hf_base(cfg.model_path)
    if arch != base_api.arch:
        if rank == 0:
            print(f"model_arch={cfg.model_arch} overridden by HF checkpoint arch {arch}")
        base_api = get_base_api(arch)
    return base_api, model_cfg, tree_map(lambda w: w.to(device), params)


def load_base(cfg, base_api, model_cfg, device, rank):
    """The frozen base params in bf16 on ``device`` from a native
    checkpoint at ``model_path``, else a random init (module docstring)."""
    if cfg.model_path and os.path.exists(cfg.model_path):
        from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only

        params = load_params_only(cfg.model_path)
        if rank == 0:
            print(f"{time.time()} base params loaded from {cfg.model_path}")
        return tree_map(lambda w: w.to(device=device, dtype=torch.bfloat16), params)
    if rank == 0:
        print(
            f"No base checkpoint at {cfg.model_path}; using random init "
            "(smoke-test mode)"
        )
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return base_api.init(generator, model_cfg, dtype=torch.bfloat16)


def main(device=None, **kwargs):
    """Train a speculator per ``TrainConfig`` overrides in ``kwargs``.
    Returns the loop's summary (``train/speculator.py::train_speculator``:
    "state", "reports", "steps") with the configs, the speculator config,
    the frozen base params, the step the run started from, the checkpoint
    manager, the feed and the stateful loader (None on dummy data)."""
    cfg = TrainConfig()
    update_config(cfg, **kwargs)
    # room for the ground-truth targets of every head
    cfg.seq_length = cfg.seq_length + cfg.n_speculator_heads + 1
    device = resolve_device(device)
    check_speculator_options(cfg)

    world = init_distributed(device)
    rank, world_size = world.rank, world.size
    if rank == 0:
        print(f"{time.time()} running with these configs {cfg}")

    # the frozen base, from one of three sources (module docstring)
    base_api = get_base_api(cfg.model_arch)
    if cfg.model_path and is_hf_checkpoint(cfg.model_path):
        base_api, model_cfg, base_params = load_hf(cfg, base_api, device, rank)
    else:
        model_cfg = {"llama": lambda: get_model_config(cfg.model_variant),
                     "gpt_bigcode": GPTBigCodeConfig,
                     "mixtral": MixtralConfig}[base_api.arch]()
        update_config(model_cfg, **kwargs)
        base_params = load_base(cfg, base_api, model_cfg, device, rank)
    with torch.no_grad():
        test_model(rank, base_params, model_cfg, base_api)

    # the speculator, replicated on every rank (the NO_SHARD analog)
    scfg = SpeculatorConfig.from_train_config(
        cfg, emb_dim=model_cfg.emb_dim, vocab_size=model_cfg.src_vocab_size
    )
    spec_params = init_speculator_params(
        torch.Generator(device=device).manual_seed(cfg.seed + 1), scfg)
    if rank == 0:
        print(f"\n{time.time()} speculator has {scfg.n_params() / 1e6} Million params\n")

    # raw packed sequences, no causal shift
    if not cfg.use_dummy_dataset:
        loader = get_data_loader(cfg, rank, world_size, postprocess=[])
        ckpt_loader = loader
    else:
        loader = get_dummy_loader(cfg, rank, world_size)
        ckpt_loader = None
    observer = build_observer(cfg, rank, device=device)
    feed = DeviceFeed(_as_batches(rebatch(loader, cfg.batch_size, cfg.batch_size)),
                      device, prefetch=max(0, int(cfg.feed_prefetch)))

    spec_state = speculator_state(spec_params, cfg)
    # the speculator is replicated: ddp
    checkpointer = build_checkpoint_manager(cfg, rank, parallel_mode="ddp")
    checkpointer.set_fingerprint(
        dict(current_fingerprint(cfg), model=f"speculator:{base_api.arch}"),
        allow_batch_change=cfg.allow_batch_change,
        allow_corpus_change=cfg.allow_corpus_change,
    )
    spec_state, _, start_step, tokens_seen, _ = checkpointer.load(
        spec_state, ckpt_loader, path=os.path.join(cfg.ckpt_load_path, "checkpoints/"),
    )
    profiler = get_profiler(cfg, rank, device=device)

    if rank == 0:
        print(f"{time.time()} Training for {cfg.num_steps} steps")
    batches = iter(feed)
    try:
        summary = train_speculator(
            cfg, base_params, model_cfg, spec_state, scfg, rank, batches,
            checkpointer, start_step, tokens_seen, profiler,
            ckpt_loader=ckpt_loader, base_api=base_api, observer=observer,
            device=device,
        )
    finally:
        if profiler:
            profiler.close()
        batches.close()
        if ckpt_loader is not None:
            ckpt_loader.shutdown()
    return dict(summary, cfg=cfg, model_cfg=model_cfg, scfg=scfg,
                base_params=base_params, start_step=start_step,
                checkpointer=checkpointer, feed=feed, loader=ckpt_loader)


if __name__ == "__main__":
    # classified failures exit with their registry code (resilience/exits.py)
    with classified_exit():
        main(**parse_cli_args(sys.argv[1:]))
