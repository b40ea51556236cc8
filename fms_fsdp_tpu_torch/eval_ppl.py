"""Native perplexity evaluation over a checkpoint of the port's trainers.

Counterpart of ``eval_ppl.py`` at the repo root. The reference evaluates
by converting the checkpoint to HF and running lm-evaluation-harness
(ref:docs/evaluation.md:1-5); that path exists here too
(``fms_to_hf_llama.py`` / ``fms_to_hf_mamba.py`` / ``fms_to_hf_mixtral.py``
and ``models/hf_import.py``). This entry evaluates natively, for any
model family: the token-mean negative log-likelihood and the perplexity
over a held-out stream from the training data pipeline, through the
training forward (``llama_forward`` / ``mamba_forward`` /
``mixtral_forward``, so the flash forward and the SSD kernels on the
card) under ``torch.no_grad()``: nothing is kept for a backward pass.

    python -m fms_fsdp_tpu_torch.eval_ppl --ckpt_load_path=/ckpts/run1 \\
        --model_variant=llama3_8b_4k --use_dummy_dataset=False \\
        --data_path=/data --datasets=dataset_1 --weights=1 --eval_batches=50

Smoke run on fresh weights: ``--use_dummy_dataset=True --ckpt_load_path=``
(an empty load path initialises from ``seed``). A load path that holds
no checkpoint raises: eval never falls back to fresh weights. Under
``torchrun`` the mesh is the train config's (``parallel/mesh.py``): each
data index evaluates its own shard of the stream, and with
``--context_parallel_size=cp`` the cp ranks of a context group read the
same rows and each evaluates its S / cp chunk of them through the ring
(ring attention; for Mamba the conv halo and ``ssd_scan_cp``; for
Mixtral the ring and the dense mix). The sums are all-reduced over the
world, which counts each token once, so every rank returns the global
figures. It runs on ``cuda`` unless ``device="cpu"`` is passed
(``--device=cpu``), and raises without a card.

Prints one JSON line (rank 0): {"nll", "ppl", "tokens", "model_variant"}.
"""

import json
import math
import os
import sys

import torch

# ckpt before utils.checkpointing: the other order is a circular import
import fms_fsdp_tpu_torch.ckpt  # noqa: F401
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.data.loader import context_chunks, get_data_loader, get_dummy_loader
from fms_fsdp_tpu_torch.models import get_model_api
from fms_fsdp_tpu_torch.models.configs import MixtralConfig
from fms_fsdp_tpu_torch.ops.flash_attention import set_kernel_variant
from fms_fsdp_tpu_torch.ops.fused_ce import IGNORE_INDEX
from fms_fsdp_tpu_torch.ops.ring_attention import context_ring
from fms_fsdp_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    context_index,
    data_index,
    data_parallel_extent,
)
from fms_fsdp_tpu_torch.parallel.mixed_precision import get_dtype_policy
from fms_fsdp_tpu_torch.train.step import check_step_options
from fms_fsdp_tpu_torch.utils.checkpointing import load_params_only
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from fms_fsdp_tpu_torch.utils.device import resolve_device
from fms_fsdp_tpu_torch.utils.dist import init_distributed
from fms_fsdp_tpu_torch.utils.tree import tree_map


def make_eval_step(model_cfg, cfg, ring=None):
    """(params, (input, label)) -> (summed token NLL, token count), as
    0-d tensors. Sums rather than means, so perplexity aggregates exactly
    over batches of unequal valid-token counts. Mixtral runs the exact
    dense mix (no capacity drops). With a context ``ring``
    (``ops/ring_attention.py``) the batch is this rank's chunk of the
    sequence and the sums are its chunk's."""
    check_step_options(cfg)
    set_kernel_variant(cfg.flash_kernel_variant)
    policy = get_dtype_policy(cfg)
    _, forward_fn, _ = get_model_api(model_cfg)
    extra = ({"moe_impl": "dense", "return_aux": True}
             if isinstance(model_cfg, MixtralConfig) else {})
    if ring is not None:
        extra["ring"] = ring

    @torch.no_grad()
    def eval_step(params, batch):
        inputs, labels = batch
        out = forward_fn(params, inputs, model_cfg, compute_dtype=policy.compute_dtype,
                         attn_impl=cfg.attention_kernel, **extra)
        logits = out[0] if isinstance(out, tuple) else out
        mask = labels != IGNORE_INDEX
        safe = torch.where(mask, labels, 0)
        m = logits.max(dim=-1, keepdim=True).values
        shifted = (logits - m).float()
        logz = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0].float()
        gold = torch.gather(logits, -1, safe[..., None])[..., 0].float()
        return ((logz - gold) * mask).sum(), mask.sum()

    return eval_step


def _load_path(path: str) -> str:
    """A run root resolves to its ``checkpoints/``; a file or a step dir
    (one holding ``state/``) is read as it is."""
    if os.path.isfile(path) or os.path.isdir(os.path.join(path, "state")):
        return path
    return os.path.join(path, "checkpoints/")


def main(device=None, **kwargs):
    """Evaluate per ``TrainConfig`` overrides in ``kwargs`` (plus
    ``eval_batches``, default 50). Returns the printed dict."""
    eval_batches = int(kwargs.pop("eval_batches", 50))
    cfg = TrainConfig()
    update_config(cfg, **kwargs)
    device = resolve_device(device)
    world = init_distributed(device)
    rank, world_size = world.rank, world.size
    mesh = build_mesh(MeshConfig.from_train_config(cfg), device_type=device.type,
                      local_world=world.local_size)

    model_cfg = get_model_config(cfg.model_variant)
    update_config(model_cfg, **kwargs)
    ring = context_ring(mesh)
    eval_step = make_eval_step(model_cfg, cfg, ring)
    # the loader by data index: the ranks of a context group read one
    # shard of the stream, each its chunk of every row
    data_rank, data_extent = data_index(mesh), data_parallel_extent(mesh)
    if not cfg.use_dummy_dataset:
        loader = get_data_loader(cfg, data_rank, data_extent)
    else:
        loader = get_dummy_loader(cfg, data_rank, data_extent)
    rows = loader if ring is None else context_chunks(loader, context_index(mesh), ring.cp)

    # params only: no optimizer state is read (load_params_only skips the
    # moments), in the policy's storage dtype
    policy = get_dtype_policy(cfg)
    if cfg.ckpt_load_path:
        params = tree_map(lambda w: w.to(device=device, dtype=policy.param_dtype),
                          load_params_only(_load_path(cfg.ckpt_load_path)))
    else:
        # fresh-init smoke mode (sanity-checking the pipeline only)
        init_params = get_model_api(model_cfg)[0]
        params = init_params(torch.Generator(device=device).manual_seed(cfg.seed),
                             model_cfg, dtype=policy.param_dtype)

    batches = iter(DeviceFeed(rows, device, prefetch=2))
    total_nll, total_tokens = 0.0, 0
    try:
        for _ in range(eval_batches):
            nll, count = eval_step(params, next(batches))
            total_nll += float(nll)
            total_tokens += int(count)
    finally:
        batches.close()
        if hasattr(loader, "shutdown"):
            loader.shutdown()
    if world_size > 1:
        sums = torch.tensor([total_nll, total_tokens], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(sums)
        total_nll, total_tokens = float(sums[0]), int(sums[1])

    nll = total_nll / max(1, total_tokens)
    result = {
        "nll": round(nll, 6),
        "ppl": round(math.exp(nll), 4),
        "tokens": total_tokens,
        "model_variant": cfg.model_variant,
    }
    if rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(**parse_cli_args(sys.argv[1:]))
