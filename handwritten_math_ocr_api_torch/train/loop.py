"""The training loop: epochs of train and val passes, the plateau
scheduler, checkpoints, early stopping, optional MLflow logging.

The port of ``handwritten_math_ocr_api_tpu/train/loop.py``, with its epoch
structure: a train pass; a val pass whose loss and argmax predictions give
``eval/metrics.compute_metrics`` (edit distance, CER, BLEU; not a full
decode); the plateau scheduler on the val loss; a checkpoint every
``checkpoint_every`` epochs and ``best_model`` at each new best edit
distance; early stopping after ``early_stop_patience`` epochs without one.
``resume_from`` continues the epochs, the optimizer and the scheduler of a
checkpoint; a checkpoint whose optimizer state does not fit this run's
chain restores the params only under a fresh optimizer, as the JAX loop
does. ``init_from`` grafts the shape-compatible subtrees of a serving
artifact into the fresh model; ``freeze_encoder_epochs`` holds the encoder
fixed for the first epochs and ``encoder_lr_mult`` scales its updates
after them. MLflow is used when it imports and an experiment is named.

The train step runs on plain ops and launches no kernel; the val pass runs
the encoder's kernels on the card (``train/step.py``).

``mesh``: a ('data', 'tensor') ``DeviceMesh`` (``parallel/mesh.
make_device_mesh``) under ``torch.distributed``, one process a device
(``torchrun``); when the process group is initialised with more than one
rank and no mesh is given, the loop builds one from ``data_axis`` and
``tensor_axis``, as JAX's loop builds one when it sees several devices.
The params and the EMA are placed by ``TP_RULES`` as DTensors, the
optimizer state is made anew over them and the rest of the state is
committed to the mesh; each batch is sharded on 'data' (every rank reads
the whole batch and keeps its rows), and DTensor inserts the collectives.
The val pass gathers the eval params once a pass and runs the eval step
(the encoder's kernels on the card) on each rank's rows; the loss sums,
token counts and predictions are gathered over 'data', so that every rank
computes the same metrics and takes the same schedule, checkpoint and
early-stopping decisions. Rank 0 writes the checkpoints (full tensors, the
one-device format: a one-device run resumes them), the plots, MLflow and
the log lines.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..convert import state_to_torch
from ..core.config import PAD_ID, Config
from ..core.device import resolve_device
from ..core.tokenizer import Tokenizer
from ..eval.metrics import compute_metrics
from ..parallel import mesh as mesh_lib
from ..utils import tree
from . import checkpoint as ckpt_lib
from .optim import PlateauScheduler, get_learning_rate, set_learning_rate
from .plots import MetricHistory
from .step import (TrainState, create_train_state, make_eval_step,
                   make_train_step)

log = logging.getLogger(__name__)


def _try_mlflow(experiment: Optional[str]):
    if not experiment:
        return None
    try:
        import mlflow

        mlflow.set_experiment(experiment)
        return mlflow
    except ImportError:
        log.warning("mlflow not installed; skipping experiment logging")
        return None


def _mlflow_log_dir(mlflow, checkpoint_dir: str, name: str,
                    artifact_path: str) -> None:
    """Log a checkpoint directory as an MLflow artifact tree; a failure of
    the artifact store is logged, never raised."""
    path = os.path.join(checkpoint_dir, name)
    try:
        mlflow.log_artifacts(path, artifact_path=artifact_path)
    except Exception as exc:  # depends on the store
        log.warning("mlflow artifact logging failed for %s: %s", path, exc)


def _graft_init(state: TrainState, artifact_dir: str) -> TrainState:
    """Graft the shape-compatible top-level subtrees of a serving artifact
    into ``state``'s params (a subtree of another structure or shape is
    skipped with a warning); the EMA restarts from the grafted params. The
    caller re-initialises the optimizer state."""
    src_params, src_ms, _, _, _ = ckpt_lib.load_params_for_serving(
        artifact_dir)
    params = dict(state.params)
    grafted = []
    for key, sub in src_params.items():
        if key not in params:
            log.warning("init-from: unknown subtree %r skipped", key)
            continue
        if tree.structure(sub) != tree.structure(params[key]):
            log.warning("init-from: subtree %r shape mismatch, skipped "
                        "(training it fresh)", key)
            continue
        params[key] = tree.map_tree(
            lambda old, new: torch.as_tensor(np.array(new)).to(
                device=old.device, dtype=old.dtype).requires_grad_(True),
            params[key], sub)
        grafted.append(key)
    if not grafted:
        raise ValueError(f"init-from: nothing shape-compatible in "
                         f"{artifact_dir}")
    log.info("init-from %s: grafted %s", artifact_dir, grafted)
    ema = state.ema_params
    if ema is not None:
        ema = tree.map_tree(lambda p: p.detach().clone(), params)
    model_state = state.model_state
    if src_ms:
        model_state = state_to_torch(src_ms, state.device)
    return state.replace(params=params, model_state=model_state,
                         ema_params=ema)


def _place_on_mesh(state: TrainState, optimizer, mesh) -> TrainState:
    """The state on ``mesh``: params and EMA by ``TP_RULES``, a fresh
    optimizer state over them, the rest replicated."""
    params = mesh_lib.shard_params(state.params, mesh)
    ema = (None if state.ema_params is None
           else mesh_lib.shard_params(state.ema_params, mesh))
    opt_state = optimizer.init(tree.leaves(params))
    return state.replace(
        params=params, ema_params=ema,
        opt_state=mesh_lib.commit_to_mesh(opt_state, mesh),
        model_state=mesh_lib.commit_to_mesh(state.model_state, mesh))


def _eval_state(state: TrainState, mesh) -> TrainState:
    """The val pass's state: on a mesh, the eval params and model state
    gathered whole (every rank), as plain tensors."""
    if mesh is None:
        return state
    with torch.no_grad():
        return state.replace(
            params=mesh_lib.full_tensors(state.eval_params),
            ema_params=None, opt_state={},
            model_state=mesh_lib.full_tensors(state.model_state))


def _val_pass(eval_step, state, val_loader, tokenizer, mesh):
    """(val loss, predictions, targets) of the val loader: the mean of the
    batches' losses, each batch's loss its non-PAD targets' mean. On a
    mesh each rank evaluates its rows, and the loss sums, target counts
    and predictions are gathered over 'data'."""
    parts = []  # per batch: (loss sum, target count, predictions)
    targets = []
    for batch in val_loader:
        images, captions = batch["image"], batch["caption"]
        tgts = np.asarray(captions)[:, 1:]
        targets.extend(tokenizer.decode_batch(tgts))
        if mesh is not None:
            images = mesh_lib.data_rows(images, mesh)
            captions = mesh_lib.data_rows(captions, mesh)
        if len(captions) == 0:  # fewer rows than data shards
            parts.append((0.0, 0, np.zeros((0, tgts.shape[1]), np.int64)))
            continue
        loss, preds = eval_step(state, images, captions)
        n = int((torch.as_tensor(captions)[:, 1:] != PAD_ID).sum())
        parts.append((float(loss) * max(n, 1), n, preds.cpu().numpy()))
    ranks = [parts]
    if mesh is not None:
        group = mesh.get_group("data")
        ranks = [None] * dist.get_world_size(group)
        dist.all_gather_object(ranks, parts, group=group)
    losses, preds = [], []
    for batch in zip(*ranks):
        total = sum(b[0] for b in batch)
        losses.append(total / max(sum(b[1] for b in batch), 1))
        preds.extend(tokenizer.decode_batch(
            np.concatenate([b[2] for b in batch])))
    return (float(np.mean(losses)) if losses else 0.0), preds, targets


def train_model(cfg: Config, train_loader: Iterable, val_loader: Iterable,
                tokenizer: Tokenizer, *, mesh=None,
                resume_from: Optional[str] = None,
                mlflow_experiment: Optional[str] = None,
                init_from: Optional[str] = None,
                freeze_encoder_epochs: int = 0,
                encoder_lr_mult: float = 1.0, device=None) -> TrainState:
    """Returns the final ``TrainState``. The loaders yield dicts with
    ``image`` (B, H, W, 1) uint8 (augmented in the step) or normalised
    floats, and ``caption`` (B, max_seq_len) int. ``device``: ``cuda``
    unless given (the tests pass ``"cpu"``); on a mesh, this rank's
    device. ``mesh``: a ``DeviceMesh`` (module docstring)."""
    dev = resolve_device(device)
    tc, mc = cfg.train, cfg.model
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = mesh_lib.make_device_mesh(tc.data_axis, tc.tensor_axis)
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, not "
                            f"{type(mesh).__name__}")
    main = mesh is None or dist.get_rank() == 0
    say = log.info if main else (lambda *args: None)
    state, optimizer = create_train_state(mc, tc, tc.seed, dev)
    if init_from:
        state = _graft_init(state, init_from)
        state = state.replace(
            opt_state=optimizer.init(tree.leaves(state.params)))
    if mesh is not None:
        say("training on mesh %s", dict(zip(mesh.mesh_dim_names,
                                             mesh.shape)))
        state = _place_on_mesh(state, optimizer, mesh)
    train_step = make_train_step(mc, tc, optimizer, data_cfg=cfg.data,
                                 encoder_update_scale=encoder_lr_mult,
                                 device=dev)
    frozen_step = None
    if freeze_encoder_epochs > 0:
        frozen_step = make_train_step(mc, tc, optimizer, data_cfg=cfg.data,
                                      encoder_update_scale=0.0, device=dev)
    eval_step = make_eval_step(mc, tc, device=dev)
    scheduler = PlateauScheduler(factor=tc.plateau_factor,
                                 patience=tc.plateau_patience)
    start_epoch = 0
    best_edit_dist = float("inf")

    if resume_from:
        try:
            state, meta = ckpt_lib.load_checkpoint(tc.checkpoint_dir,
                                                   resume_from, state)
        except ValueError as e:
            log.warning("resume: checkpoint optimizer state does not "
                        "match this run's optimizer chain (%s); "
                        "restoring params only with a fresh optimizer",
                        str(e).splitlines()[0])
            state, meta = ckpt_lib.load_checkpoint(
                tc.checkpoint_dir, resume_from, state, params_only=True)
            opt_state = optimizer.init(tree.leaves(state.params))
            if mesh is not None:
                opt_state = mesh_lib.commit_to_mesh(opt_state, mesh)
            state = state.replace(opt_state=opt_state)
        start_epoch = int(meta.get("epoch", 0))
        best_edit_dist = float(meta.get("metric_value", float("inf")))
        if meta.get("scheduler"):
            scheduler = PlateauScheduler.from_state_dict(meta["scheduler"])
        say("resumed from %s at epoch %d", resume_from, start_epoch)

    mlflow = _try_mlflow(mlflow_experiment) if main else None
    if mlflow:
        mlflow.start_run()
        mlflow.log_params({
            "learning_rate": tc.learning_rate, "epochs": tc.epochs,
            "label_smoothing": tc.label_smoothing,
            "encoder": mc.encoder, "d_model": mc.d_model,
        })

    data_seed = tc.seed + 1
    no_improvement = 0
    history = MetricHistory()
    try:
        for epoch in range(start_epoch, tc.epochs):
            t0 = time.time()
            # ---- train pass ----
            step_fn = (frozen_step if frozen_step is not None
                       and epoch < freeze_encoder_epochs else train_step)
            train_losses = []
            for batch in train_loader:
                images, captions = batch["image"], batch["caption"]
                if mesh is not None:
                    images, captions = mesh_lib.shard_batch(
                        (images, captions), mesh)
                state, metrics = step_fn(state, images, captions, data_seed)
                train_losses.append(metrics["loss"])
            train_loss = (float(torch.stack(train_losses).mean())
                          if train_losses else 0.0)

            # ---- val pass: loss and argmax metrics ----
            val_loss, all_preds, all_tgts = _val_pass(
                eval_step, _eval_state(state, mesh), val_loader, tokenizer,
                mesh)
            metrics = compute_metrics(all_preds, all_tgts)

            # ---- schedule and logging ----
            lr = get_learning_rate(state.opt_state)
            new_lr = scheduler.step(val_loss, lr)
            if new_lr != lr:
                opt_state = set_learning_rate(state.opt_state, new_lr)
                if mesh is not None:
                    opt_state = mesh_lib.commit_to_mesh(opt_state, mesh)
                state = state.replace(opt_state=opt_state)
                say("plateau: lr %.2e -> %.2e", lr, new_lr)

            say(
                "epoch %d/%d | train %.4f | val %.4f | edit %.2f | cer %.4f "
                "| bleu %.4f | %.1fs",
                epoch + 1, tc.epochs, train_loss, val_loss,
                metrics["edit_distance"], metrics["cer"], metrics["bleu"],
                time.time() - t0)
            history.append(train_loss=train_loss, val_loss=val_loss,
                           edit_distance=metrics["edit_distance"],
                           cer=metrics["cer"], bleu=metrics["bleu"])
            if mlflow:
                mlflow.log_metrics({
                    "train_loss": train_loss, "val_loss": val_loss,
                    "edit_distance": metrics["edit_distance"],
                    "cer": metrics["cer"], "bleu": metrics["bleu"],
                    "lr": new_lr,
                }, step=epoch + 1)

            # ---- checkpoints ----
            sched_sd = scheduler.state_dict()
            if (epoch + 1) % tc.checkpoint_every == 0:
                name = f"checkpoint_epoch_{epoch + 1}"
                ckpt_lib.save_checkpoint(
                    tc.checkpoint_dir, name,
                    state, epoch + 1, metrics["edit_distance"], sched_sd)
                if mlflow:
                    _mlflow_log_dir(mlflow, tc.checkpoint_dir, name,
                                    f"checkpoints/{name}")
            if metrics["edit_distance"] < best_edit_dist:
                best_edit_dist = metrics["edit_distance"]
                no_improvement = 0
                ckpt_lib.save_checkpoint(
                    tc.checkpoint_dir, "best_model", state, epoch + 1,
                    best_edit_dist, sched_sd)
                say("new best edit distance: %.2f", best_edit_dist)
                if mlflow:
                    _mlflow_log_dir(mlflow, tc.checkpoint_dir,
                                    "best_model", "model")
            else:
                no_improvement += 1
                say("no improvement %d/%d", no_improvement,
                    tc.early_stop_patience)
            if no_improvement >= tc.early_stop_patience:
                say("early stopping at epoch %d", epoch + 1)
                break
    finally:
        plot_path = os.path.join(tc.checkpoint_dir, "training_curves.png")
        if main and history.save_plot(plot_path) and mlflow:
            mlflow.log_artifact(plot_path)
        if mlflow:
            mlflow.end_run()
    return state
