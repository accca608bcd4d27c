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
the encoder's kernels on the card (``train/step.py``). One card: a device
mesh (``mesh=``) is not ported.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.tokenizer import Tokenizer
from ..eval.metrics import compute_metrics
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
    return state.replace(params=params, model_state=src_ms or
                         state.model_state, ema_params=ema)


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
    unless given (the tests pass ``"cpu"``)."""
    if mesh is not None:
        raise NotImplementedError(
            "train_model(mesh=...): training over a device mesh is not "
            "ported (ROADMAP A8); the port trains on one card")
    dev = resolve_device(device)
    tc, mc = cfg.train, cfg.model
    state, optimizer = create_train_state(mc, tc, tc.seed, dev)
    if init_from:
        state = _graft_init(state, init_from)
        state = state.replace(
            opt_state=optimizer.init(tree.leaves(state.params)))
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
            state = state.replace(
                opt_state=optimizer.init(tree.leaves(state.params)))
        start_epoch = int(meta.get("epoch", 0))
        best_edit_dist = float(meta.get("metric_value", float("inf")))
        if meta.get("scheduler"):
            scheduler = PlateauScheduler.from_state_dict(meta["scheduler"])
        log.info("resumed from %s at epoch %d", resume_from, start_epoch)

    mlflow = _try_mlflow(mlflow_experiment)
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
                state, metrics = step_fn(state, batch["image"],
                                         batch["caption"], data_seed)
                train_losses.append(metrics["loss"])
            train_loss = (float(torch.stack(train_losses).mean())
                          if train_losses else 0.0)

            # ---- val pass: loss and argmax metrics ----
            val_losses, all_preds, all_tgts = [], [], []
            for batch in val_loader:
                loss, preds = eval_step(state, batch["image"],
                                        batch["caption"])
                val_losses.append(float(loss))
                all_preds.extend(tokenizer.decode_batch(
                    preds.cpu().numpy()))
                all_tgts.extend(tokenizer.decode_batch(
                    np.asarray(batch["caption"])[:, 1:]))
            val_loss = float(np.mean(val_losses)) if val_losses else 0.0
            metrics = compute_metrics(all_preds, all_tgts)

            # ---- schedule and logging ----
            lr = get_learning_rate(state.opt_state)
            new_lr = scheduler.step(val_loss, lr)
            if new_lr != lr:
                state = state.replace(opt_state=set_learning_rate(
                    state.opt_state, new_lr))
                log.info("plateau: lr %.2e -> %.2e", lr, new_lr)

            log.info(
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
                log.info("new best edit distance: %.2f", best_edit_dist)
                if mlflow:
                    _mlflow_log_dir(mlflow, tc.checkpoint_dir,
                                    "best_model", "model")
            else:
                no_improvement += 1
                log.info("no improvement %d/%d", no_improvement,
                         tc.early_stop_patience)
            if no_improvement >= tc.early_stop_patience:
                log.info("early stopping at epoch %d", epoch + 1)
                break
    finally:
        plot_path = os.path.join(tc.checkpoint_dir, "training_curves.png")
        if history.save_plot(plot_path) and mlflow:
            mlflow.log_artifact(plot_path)
        if mlflow:
            mlflow.end_run()
    return state
