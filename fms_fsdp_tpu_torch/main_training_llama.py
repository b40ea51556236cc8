"""Llama pretraining entry point of the port.

Counterpart of ``main_training_llama.py`` at the repo root, in the same
order — config -> process group -> mesh -> model -> checkpoint manager ->
elastic batch policy -> dataloader -> sharded train state -> checkpoint
load -> LR schedule -> train — with one card per process. A run that
finds a committed checkpoint under ``ckpt_save_path`` (or a local tier's
``ckpt_local_dir``) resumes from it, on any world size whose
data-parallel extent divides the checkpoint's global batch (the per-rank
batch is resized to keep it); else ``ckpt_load_path`` (a run root or a
params pickle) is loaded as continued pretraining, from step 0. The same
command line runs both:

    python -m fms_fsdp_tpu_torch.main_training_llama \\
        --model_variant=llama3_8b_4k --LlamaConfig.nlayers=8 \\
        --use_dummy_dataset=True --batch_size=2 --seq_length=4096 \\
        --vocab_size=128256 --fsdp_activation_checkpointing=True \\
        --selective_checkpointing=0.5 --num_steps=12 --report_interval=4

With ``--use_dummy_dataset=False`` it streams the pre-tokenised arrow
shards under ``--data_path`` through ``data/loader.py::get_data_loader``
(corpora and weights from ``--datasets``/``--weights``), and the loader's
state rides every checkpoint, so a resume continues the stream:

    python -m fms_fsdp_tpu_torch.main_training_llama \
        --model_variant=llama3_8b_4k --LlamaConfig.nlayers=8 \
        --use_dummy_dataset=False --data_path=/data/corpus \
        --datasets=dataset_1,dataset_2 --weights=3,1 --num_workers=2 \
        --batch_size=2 --seq_length=4096 --vocab_size=128256 \
        --ckpt_save_path=/ckpt/run1 --num_steps=12

Across processes, ``torchrun`` starts one process per card (gloo on the
CPU with ``--device=cpu``) and ``--sharding_strategy`` picks ddp, fsdp or
hsdp (``--sharding_group_size``); ``--batch_size`` is per process, as in
the reference, and only rank 0 prints:

    torchrun --nproc_per_node=4 -m fms_fsdp_tpu_torch.main_training_llama \
        --sharding_strategy=fsdp --model_variant=llama3_8b_4k \
        --use_dummy_dataset=True --batch_size=2 --seq_length=4096 \
        --vocab_size=128256 --num_steps=12

``--context_parallel_size=cp`` splits each row's sequence over cp
adjacent ranks (ring attention, and for Mamba the conv halo and
``ssd_scan_cp``): the ranks of a context group read the same loader rows
(at their data index, ``parallel/mesh.py::data_index``) and each trains
its own S / cp chunk of inputs and labels; the world is data ranks x cp:

    torchrun --nproc_per_node=4 -m fms_fsdp_tpu_torch.main_training_llama \
        --sharding_strategy=fsdp --context_parallel_size=2 \
        --model_variant=llama3_8b --use_dummy_dataset=True --batch_size=1 \
        --seq_length=32768 --vocab_size=128256 --num_steps=12

``--tensor_parallel_size=tp`` (or ``--sharding_strategy=tp``, fsdp over
the rest) splits every layer over tp adjacent ranks in JAX's Megatron
layout (``parallel/tensor.py``): the ranks of a tensor group read the
same loader rows and each holds its block of the weights, the
attention running on its heads; the world is data ranks x cp x tp, and
the mesh line prints the ``tensor`` axis. Ranks that share one card
(two ranks on one H100) form a gloo world (``utils/dist.py``):

    torchrun --nproc_per_node=2 -m fms_fsdp_tpu_torch.main_training_llama \
        --sharding_strategy=fsdp --tensor_parallel_size=2 \
        --model_variant=llama3_8b_4k --use_dummy_dataset=True --batch_size=2 \
        --seq_length=4096 --vocab_size=128256 --num_steps=3

The observability and resilience options run as in JAX: ``--obs_dir``
(``metrics.jsonl``, ``metrics.csv`` with ``--obs_sinks=jsonl,csv``, and
``heartbeat.json``), ``--use_profiler`` (a ``torch.profiler`` trace in
``profile_traces/`` under the working directory), ``--step_timeout_s``,
``--scrub_interval_steps`` and ``--faults`` (or ``FMS_FAULTS``). Run as a
script, ``main`` runs inside ``classified_exit()``, so an anomaly abort,
a dead loader or a lost corpus exits with its registry code for the
supervisor (``python -m fms_fsdp_tpu_torch.resilience.supervisor``).

It runs on ``cuda`` unless ``device="cpu"`` is passed to :func:`main`
(``--device=cpu``), and raises without a card. Options not ported yet
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

import os
import sys

import torch

from fms_fsdp_tpu_torch.ckpt import build_checkpoint_manager
from fms_fsdp_tpu_torch.ckpt.elastic import current_fingerprint
from fms_fsdp_tpu_torch.config import TrainConfig
from fms_fsdp_tpu_torch.data.device_feed import DeviceFeed
from fms_fsdp_tpu_torch.data.loader import (
    context_chunks,
    elastic_batch_size,
    get_data_loader,
    get_dummy_loader,
)
from fms_fsdp_tpu_torch.obs import build_observer
from fms_fsdp_tpu_torch.parallel.mesh import (
    MeshConfig,
    axis_sizes,
    build_mesh,
    context_index,
    data_index,
    data_parallel_extent,
    tensor_index,
)
from fms_fsdp_tpu_torch.resilience.exits import classified_exit
from fms_fsdp_tpu_torch.resilience.faults import configure_faults
from fms_fsdp_tpu_torch.train.step import (
    check_supported,
    init_train_state,
    make_train_step,
)
from fms_fsdp_tpu_torch.utils.cli import parse_cli_args
from fms_fsdp_tpu_torch.utils.config_utils import get_model_config, update_config
from fms_fsdp_tpu_torch.utils.device import resolve_device
from fms_fsdp_tpu_torch.utils.dist import init_distributed
from fms_fsdp_tpu_torch.utils.train_utils import get_profiler, train


def main(device=None, **kwargs):
    """Train per ``TrainConfig`` overrides in ``kwargs``. Returns the
    loop's summary (``utils/train_utils.py::train``) with the final train
    state, the resolved configs, the step the run started from, the
    checkpoint manager, the device feed (its ``wait_s``), the stateful
    loader (None on dummy data, shut down) and the mesh under "state",
    "cfg", "model_cfg", "start_step", "checkpointer", "feed", "loader"
    and "mesh"."""
    cfg = TrainConfig()
    update_config(cfg, **kwargs)
    device = resolve_device(device)
    check_supported(cfg)
    if cfg.faults:
        # the spec from the config; FMS_FAULTS is read lazily when empty
        configure_faults(cfg.faults)

    world = init_distributed(device)
    rank = world.rank
    if rank == 0:
        print(f"--> running with these configs {cfg}")

    # the mesh (the reference's FSDP sharding strategy)
    mesh = build_mesh(MeshConfig.from_train_config(cfg), device_type=device.type,
                      local_world=world.local_size)
    data_extent = data_parallel_extent(mesh)
    if rank == 0:
        print(f"Sharding strategy = {cfg.sharding_strategy}, mesh = {axis_sizes(mesh)}, "
              f"process group = {torch.distributed.get_backend()}")

    # model config; dotted CLI overrides (LlamaConfig.param=value) apply here
    model_cfg = get_model_config(cfg.model_variant)
    update_config(model_cfg, **kwargs)
    if rank == 0:
        print(f"\n--> model has {model_cfg.n_params() / 1e6} Million params\n")

    # checkpoint manager BEFORE the dataloader, as in the JAX entry: an
    # elastic resume resolves the per-rank batch that keeps the saved
    # global batch before any per-rank row count is baked into the loader
    checkpointer = build_checkpoint_manager(cfg, rank)
    resume_topology = checkpointer.resume_topology()

    if rank == 0:
        print("Constructing datasets...")
    # one device a process: the processes are the data ranks x the context
    # group's x the tensor group's (the mesh checked the world divides);
    # tensor peers read the same rows
    cp = axis_sizes(mesh)["context"]
    data_rank = data_index(mesh)
    if resume_topology:
        cfg.batch_size = elastic_batch_size(cfg, resume_topology, data_extent, rank)
    # (re)stamp the fingerprint with the resolved batch size: what every
    # save writes and what load checks a rescale against
    checkpointer.set_fingerprint(
        current_fingerprint(cfg),
        allow_batch_change=cfg.allow_batch_change,
        allow_corpus_change=cfg.allow_corpus_change,
    )
    if not cfg.use_dummy_dataset:
        loader = get_data_loader(cfg, data_rank, data_extent)
        # interval/final/abort checkpoints persist this live loader's
        # state next to the model (train(dataloader=)); context and tensor
        # peers hold the same state, and their rank 0 alone writes it
        ckpt_loader = loader
    else:
        loader = get_dummy_loader(cfg, data_rank, data_extent)
        ckpt_loader = None  # dummy stream is stateless
    batches = loader if cp == 1 else context_chunks(loader, context_index(mesh), cp)
    if rank == 0:
        print("Datasets constructed!")

    # the train state, this rank's parts of it on a sharded mesh
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_train_state(generator, model_cfg, cfg, mesh)

    # a run-root load path points at its checkpoints/ subdir; a file path
    # loads directly (ref:main_training_llama.py:124-127)
    state, _, start_step, tokens_seen, is_resuming = checkpointer.load(
        state,
        ckpt_loader,
        path=os.path.join(cfg.ckpt_load_path, "checkpoints/")
        if not os.path.isfile(cfg.ckpt_load_path)
        else cfg.ckpt_load_path,
        strict=False,
    )
    if not is_resuming:
        start_step = 0
    # the schedule runs from the state's own restored step, as JAX's does
    step_fn = make_train_step(model_cfg, cfg)
    profiler = get_profiler(cfg, rank, device=device)
    # metrics registry, phase timing, sinks and heartbeat
    observer = build_observer(cfg, rank, model_cfg=model_cfg, device=device)

    feed = DeviceFeed(batches, device, prefetch=max(0, int(cfg.feed_prefetch)))
    if rank == 0:
        print(f"Training for {cfg.num_steps} steps")
    batches = iter(feed)
    try:
        summary = train(cfg, state, step_fn, rank, batches, checkpointer,
                        start_step, tokens_seen,
                        dataloader=(ckpt_loader if context_index(mesh) == 0
                                    and tensor_index(mesh) == 0 else None),
                        model_cfg=model_cfg, device=device, profiler=profiler,
                        observer=observer)
    finally:
        # stop the feed's thread, then the loader's workers (joined,
        # processes reaped)
        batches.close()
        if ckpt_loader is not None:
            ckpt_loader.shutdown()
    return dict(summary, state=state, cfg=cfg, model_cfg=model_cfg,
                start_step=start_step, checkpointer=checkpointer, feed=feed,
                loader=ckpt_loader, observer=observer, mesh=mesh)


if __name__ == "__main__":
    # classified failures exit with their registry code (resilience/exits.py)
    # so the supervisor maps the exit to a restart policy
    with classified_exit():
        main(**parse_cli_args(sys.argv[1:]))
