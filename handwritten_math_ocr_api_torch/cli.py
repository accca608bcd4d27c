"""Command-line interface of the port.

The port of ``handwritten_math_ocr_api_tpu/cli.py``, with the same
subcommands and flags:

    python -m handwritten_math_ocr_api_torch build-vocab --data-root D \
        --checkpoint-dir C [--include-val]
    python -m handwritten_math_ocr_api_torch train --data-root D \
        --checkpoint-dir C [--synthetic-stream N] [--epochs E] ...
    python -m handwritten_math_ocr_api_torch evaluate --data-root D \
        --checkpoint-dir C [--checkpoint best_model] [--beam-size K] ...
    python -m handwritten_math_ocr_api_torch predict IMAGE \
        --checkpoint-dir C [--beam-size K | --temperature T ...]
    python -m handwritten_math_ocr_api_torch make-synthetic|make-corpus \
        --data-root D [--renderer stroke [--hard] [--envs]] ...
    python -m handwritten_math_ocr_api_torch render-inkml INKML_DIR \
        OUT_IMG_DIR OUT_CSV [--limit N]
    python -m handwritten_math_ocr_api_torch extend-vocab|convert-gqa ...
    python -m handwritten_math_ocr_api_torch convert-checkpoint PTH \
        VOCAB OUT_DIR [--encoder resnet18] [--model-overrides JSON]
    python -m handwritten_math_ocr_api_torch convert-encoder PTH OUT_DIR
    python -m handwritten_math_ocr_api_torch export OUT_DIR \
        --checkpoint-dir C [--checkpoint best_model] [--use-ema]
    python -m handwritten_math_ocr_api_torch serve --model-dir DIR \
        [--host H] [--port P]
    python -m handwritten_math_ocr_api_torch calibrate --results CSV \
        [--out calibration.json] [--method platt|isotonic] [--bins N]

Training, evaluation, prediction and serving run on the card (``train``,
``evaluate`` and ``predict`` take ``--device cpu`` for the host); the data
and checkpoint tools run on the host. ``evaluate`` and ``predict`` read a
training checkpoint of the port or of the JAX package (its params).
``serve`` takes its settings from the environment as the JAX package's
does (``ServeConfig.from_env``). ``convert-checkpoint`` makes a serving
artifact of a reference ``.pth`` (``compat/torch_convert.py``),
``convert-encoder`` an encoder-only artifact of torchvision's ``swin_t``
for ``train --init-from``, and ``export`` a serving artifact of a training
checkpoint, with its model state. ``train`` also runs under ``torchrun
--nproc-per-node=N``, one process a card (``--device cpu``: a gloo group
on the host), on a ('data', 'tensor') mesh of the ranks
(``train/loop.py``). ``--model-overrides`` also takes a
nested ``"resnet"`` dict of ``ResNetConfig`` fields. The synthetic stream
and ``make-corpus`` take the handwriting-stroke renderer
(``data/strokes.py``: ``--stream-renderer stroke``, ``--stream-hard`` with
``--stream-degrade``, ``--stream-native-render`` on the host C++ library;
``--renderer stroke --hard``), and ``render-inkml`` rasterizes InkML
(``data/inkml.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _common_data_args(p):
    p.add_argument("--data-root", default=os.environ.get(
        "MATHOCR_DATA_ROOT", "data"))
    p.add_argument("--checkpoint-dir", default=os.environ.get(
        "MATHOCR_CKPT_DIR", "checkpoints"))
    p.add_argument("--model-overrides", default=None,
                   help="JSON dict of ModelConfig field overrides, e.g. "
                        '\'{"d_model": 64, "num_decoder_layers": 2}\'; '
                        '"swin" may be a nested dict of SwinConfig fields, '
                        '"resnet" one of ResNetConfig fields')


def _device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' for the host)")


def _model_config(args, vocab_size: int):
    from .core.config import ModelConfig, ResNetConfig, SwinConfig

    cfg = ModelConfig(encoder=args.encoder, vocab_size=vocab_size)
    if getattr(args, "model_overrides", None):
        raw = json.loads(args.model_overrides)
        if "swin" in raw:
            sw = dict(raw.pop("swin"))
            for key in ("depths", "num_heads"):
                if key in sw:
                    sw[key] = tuple(sw[key])
            cfg = cfg.replace(swin=SwinConfig(**sw))
        if "resnet" in raw:
            rn = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.pop("resnet").items()}
            cfg = cfg.replace(resnet=ResNetConfig(**rn))
        cfg = cfg.replace(**raw)
    return cfg


def cmd_build_vocab(args) -> int:
    from .core.tokenizer import create_vocab_from_csvs, save_vocab

    paths = [os.path.join(args.data_root, "train_labels.csv")]
    if args.include_val:
        paths.append(os.path.join(args.data_root, "validate_labels.csv"))
    vocab = create_vocab_from_csvs(paths)
    out = os.path.join(args.checkpoint_dir, "vocab.json")
    save_vocab(vocab, out)
    print(f"vocab: {len(vocab)} tokens -> {out}")
    return 0


def _torchrun_device(device):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): this rank's card
    (``LOCAL_RANK``), set as the current device, and the process group
    initialised from torchrun's environment (NCCL on the cards, gloo with
    ``--device cpu``); returns the rank's device. Otherwise ``device``."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    import torch
    import torch.distributed as dist

    if device == "cpu":
        dist.init_process_group("gloo")
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    return f"cuda:{local}"


def cmd_train(args) -> int:
    import torch.distributed as dist

    device = _torchrun_device(args.device)
    try:
        return _train(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device) -> int:
    from .core.config import Config, DataConfig, TrainConfig
    from .core.tokenizer import Tokenizer, load_vocab, save_vocab
    from .data.dataset import DataLoader, get_data_loaders
    from .train.loop import train_model

    vpath = os.path.join(args.checkpoint_dir, "vocab.json")
    if args.synthetic_stream:
        # an endless synthetic stream: the vocab comes from the grammar
        from .data.synthetic import SyntheticStreamDataset, grammar_vocab

        gvocab = grammar_vocab(rich=args.stream_hard, envs=args.stream_envs)
        if args.resume_from and os.path.exists(vpath):
            # fine-tuning keeps the checkpoint's token ids (an
            # extend-vocab artifact appends tokens a fresh grammar vocab
            # would re-sort)
            vocab, idx2char = load_vocab(vpath)
            missing = sorted(set(gvocab) - set(vocab))
            if missing:
                print(f"warning: stream grammar emits tokens absent from "
                      f"the checkpoint vocab (will encode as <unk>): "
                      f"{missing}; run extend-vocab first", file=sys.stderr)
        else:
            vocab = gvocab
            save_vocab(vocab, vpath)
            idx2char = {i: t for t, i in vocab.items()}
    else:
        vocab, idx2char = load_vocab(vpath)
    tok = Tokenizer(vocab, idx2char)
    cfg = Config(
        model=_model_config(args, len(vocab)),
        data=DataConfig(data_root=args.data_root,
                        batch_size=args.batch_size,
                        num_workers=args.num_workers),
        train=TrainConfig(checkpoint_dir=args.checkpoint_dir,
                          epochs=args.epochs,
                          learning_rate=args.learning_rate,
                          warmup_steps=args.warmup_steps,
                          early_stop_patience=args.early_stop_patience,
                          ema_decay=args.ema_decay),
    )
    if args.synthetic_stream:
        mc = cfg.model
        stroke = args.stream_renderer == "stroke"
        if stroke:
            from .data.strokes import StrokeStreamDataset as stream_ds
        else:
            stream_ds = SyntheticStreamDataset
        hard = {}
        if args.stream_hard:
            # the MathWriting-difficulty regime: the extended inventory,
            # longer and deeper formulas, and (stroke renderer) degraded ink
            hard = dict(rich=True, max_tokens=args.stream_max_tokens,
                        max_terms=8, depth=3)
            if stroke:
                hard["degrade"] = args.stream_degrade
        if args.stream_envs:
            hard["envs"] = True
        if args.stream_native_render:
            if not stroke:
                raise SystemExit("--stream-native-render requires "
                                 "--stream-renderer stroke")
            hard["native"] = True

        def mk(n, seed, freeze):
            return DataLoader(
                stream_ds(tok, n, mc.img_h, mc.img_w, mc.max_seq_len,
                          seed=seed, freeze=freeze, **hard),
                cfg.data.batch_size, shuffle=False,
                num_workers=cfg.data.num_workers, drop_remainder=True)

        train_loader = mk(args.synthetic_stream, 0, False)
        val_loader = mk(max(args.batch_size * 16, 1024), 777, True)
    else:
        train_loader, val_loader = get_data_loaders(tok, cfg.data, cfg.model)
    train_model(cfg, train_loader, val_loader, tok,
                resume_from=args.resume_from,
                mlflow_experiment=args.mlflow_experiment,
                init_from=args.init_from,
                freeze_encoder_epochs=args.freeze_encoder_epochs,
                encoder_lr_mult=args.encoder_lr_mult, device=device)
    return 0


def _load_for_decode(args):
    """(tokenizer, model config, eval params, model state) of
    ``--checkpoint``."""
    from .core.config import TrainConfig
    from .core.tokenizer import Tokenizer, load_vocab
    from .train.checkpoint import load_checkpoint
    from .train.step import create_train_state
    from .utils import tree

    vocab, idx2char = load_vocab(
        os.path.join(args.checkpoint_dir, "vocab.json"))
    tok = Tokenizer(vocab, idx2char)
    mc = _model_config(args, len(vocab))
    # a slot for the EMA when it is asked for (a checkpoint without one
    # gives the raw weights)
    tc = TrainConfig(ema_decay=0.999 if args.use_ema else 0.0)
    state, _ = create_train_state(mc, tc, device=args.device)
    state, _meta = load_checkpoint(args.checkpoint_dir, args.checkpoint,
                                   state, params_only=True)
    params = tree.map_tree(lambda p: p.detach(), state.eval_params)
    return tok, mc, params, state.model_state


def cmd_evaluate(args) -> int:
    from .core.config import DataConfig, DecodeConfig
    from .data.dataset import get_test_loader
    from .decode.api import DecodeEngine
    from .eval.harness import evaluate_model, save_results

    tok, mc, params, model_state = _load_for_decode(args)
    dc = DataConfig(data_root=args.data_root, batch_size=args.batch_size)
    engine = DecodeEngine(params, mc, DecodeConfig(), tok,
                          use_fused=args.use_fused, quantize=args.quantize,
                          constrained=args.constrained,
                          model_state=model_state, device=args.device)
    if args.constrained and args.beam_size and args.beam_size > 1:
        print("warning: --constrained applies to the greedy path only; "
              "beam search evaluates UNCONSTRAINED", file=sys.stderr)
    results = evaluate_model(engine, get_test_loader(tok, dc, mc), tok,
                             beam_size=args.beam_size)
    save_results(results, args.out_dir)
    s = results["summary"]
    print(f"accuracy={s['accuracy']:.4f} cer={s['corpus_cer']:.4f} "
          f"bleu={s['bleu']:.4f} ({s['images_per_sec']:.1f} img/s)")
    return 0


def cmd_predict(args) -> int:
    from .core.config import DecodeConfig
    from .data.preprocess import preprocess_file
    from .decode.api import DecodeEngine

    tok, mc, params, model_state = _load_for_decode(args)
    engine = DecodeEngine(params, mc, DecodeConfig(), tok,
                          constrained=args.constrained,
                          model_state=model_state, device=args.device)
    img = preprocess_file(args.image, mc)
    sampled = args.temperature or args.top_k or args.top_p
    if args.constrained and (sampled or (args.beam_size
                                         and args.beam_size > 1)):
        print("warning: --constrained applies to the greedy path only; "
              "beam/sampled decodes run UNCONSTRAINED", file=sys.stderr)
    if args.beam_size and args.beam_size > 1:
        out = engine.predict_batch(img, beam_size=args.beam_size)[0]
        print("Predicted LaTeX:", out)
    elif sampled:
        latex, conf = engine.predict_single_sampled(
            img[0], temperature=args.temperature or 1.0,
            top_k=args.top_k or 0, top_p=args.top_p or 1.0, seed=args.seed)
        print("Predicted LaTeX:", latex)
        print(f"Confidence: {conf:.4f}")
    else:
        latex, conf = engine.predict_single(img[0])
        print("Predicted LaTeX:", latex)
        print(f"Confidence: {conf:.4f}")
    return 0


def cmd_convert(args) -> int:
    """A reference PyTorch ``.pth`` -> a serving artifact directory."""
    from .compat.torch_convert import convert_checkpoint
    from .core.tokenizer import load_vocab
    from .train.checkpoint import save_params_for_serving

    vocab, _ = load_vocab(args.vocab)
    cfg = _model_config(args, len(vocab))
    params, bn_state = convert_checkpoint(args.pth, cfg)
    out = save_params_for_serving(args.out_dir, params, vocab, cfg,
                                  model_state=bn_state)
    print(f"serving artifact -> {out}")
    return 0


def cmd_convert_encoder(args) -> int:
    """A raw torchvision ``swin_t`` ``.pth`` (ImageNet weights) -> an
    encoder-only artifact for ``train --init-from`` (its patch
    convolution averaged to one channel)."""
    from .compat.torch_convert import (
        convert_torchvision_swin,
        load_torch_state_dict,
    )
    from .core.config import ModelConfig
    from .train.checkpoint import save_params_for_serving

    cfg = ModelConfig(encoder="swin_t")
    enc = convert_torchvision_swin(load_torch_state_dict(args.pth), cfg)
    # it initialises training and does not serve: the specials as vocab
    vocab = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3}
    out = save_params_for_serving(args.out_dir, {"encoder": enc}, vocab,
                                  cfg)
    print(f"encoder artifact -> {out}")
    return 0


def cmd_export(args) -> int:
    """A training checkpoint -> a serving artifact directory (the params,
    the model state, the vocab and the model config), read through
    ``--device`` (``cuda`` unless given)."""
    from .core.config import TrainConfig
    from .core.tokenizer import load_vocab
    from .train.checkpoint import load_checkpoint, save_params_for_serving
    from .train.step import create_train_state

    vocab, _ = load_vocab(os.path.join(args.checkpoint_dir, "vocab.json"))
    mc = _model_config(args, len(vocab))
    # a slot for the EMA when it is asked for
    tc = TrainConfig(ema_decay=0.999 if args.use_ema else 0.0)
    state, _ = create_train_state(mc, tc, device=args.device)
    state, _meta = load_checkpoint(args.checkpoint_dir, args.checkpoint,
                                   state, params_only=True)
    out = save_params_for_serving(args.out_dir, state.eval_params, vocab,
                                  mc, model_state=state.model_state)
    kind = "ema" if (args.use_ema and state.ema_params is not None) else "raw"
    print(f"serving artifact ({kind} weights) -> {out}")
    return 0


def cmd_make_synthetic(args) -> int:
    from .data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(
        args.data_root,
        splits=(("train", args.train), ("validate", args.val),
                ("test", args.test)))
    print(f"synthetic dataset -> {args.data_root}")
    return 0


def cmd_render_inkml(args) -> int:
    from .data.inkml import render_inkml_dir

    n = render_inkml_dir(args.inkml_dir, args.out_img_dir, args.out_csv,
                         limit=args.limit)
    print(f"rendered {n} inkml files -> {args.out_img_dir}")
    return 0


def cmd_make_corpus(args) -> int:
    kw = {}
    if args.renderer == "stroke":
        from .data.strokes import make_stroke_corpus as mk

        if args.hard:  # the regime of train --stream-hard
            kw = dict(rich=True, max_tokens=args.max_tokens, max_terms=8,
                      depth=3, degrade=args.degrade)
        if args.envs:
            kw["envs"] = True
    else:
        from .data.synthetic import make_corpus as mk

        if args.hard:
            raise SystemExit("--hard requires --renderer stroke")
        if args.envs:
            raise SystemExit("--envs requires --renderer stroke")
    mk(args.data_root, n_train=args.train, n_val=args.val, n_test=args.test,
       seed=args.seed, **kw)
    print(f"learnable corpus ({args.train}/{args.val}/{args.test}, "
          f"{args.renderer}) -> {args.data_root}")
    return 0


def cmd_extend_vocab(args) -> int:
    """Append tokens to a checkpoint's vocab and grow its decoder head
    (train/vocab_extend.py)."""
    from .core.tokenizer import load_vocab
    from .train.vocab_extend import extend_checkpoint

    vocab, _ = load_vocab(os.path.join(args.checkpoint_dir, "vocab.json"))
    mc = _model_config(args, len(vocab))
    tokens = args.tokens.split(",") if args.tokens else None
    path, added = extend_checkpoint(args.checkpoint_dir, args.checkpoint,
                                    args.out_dir, mc, new_tokens=tokens,
                                    seed=args.seed, device="cpu")
    print(f"extended checkpoint -> {path} (+{len(added)} tokens: "
          f"{' '.join(added)})")
    return 0


def cmd_convert_gqa(args) -> int:
    """Mean-pool an MHA checkpoint's self-attention K/V heads into
    ``nhead_kv`` groups (train/gqa_convert.py)."""
    from .core.tokenizer import load_vocab
    from .train.gqa_convert import convert_to_gqa

    vocab, _ = load_vocab(os.path.join(args.checkpoint_dir, "vocab.json"))
    mc = _model_config(args, len(vocab))
    path, cfg_new = convert_to_gqa(args.checkpoint_dir, args.checkpoint,
                                   args.out_dir, mc, args.nhead_kv,
                                   device="cpu")
    print(f"GQA checkpoint -> {path} (nhead_kv={cfg_new.nhead_kv}, "
          f"self-KV cache /{mc.nhead // cfg_new.kv_heads})")
    return 0


def cmd_calibrate(args) -> int:
    """Fit a confidence calibrator from an eval CSV (eval/calibration.py).

    Input: the test_results.csv of a greedy evaluation, which carries each
    sample's confidence and exact_match. Output: calibration.json, which
    the serving app applies from the model dir."""
    import csv as _csv

    from .eval import calibration as calib

    conf, correct = [], []
    with open(args.results) as f:
        for row in _csv.DictReader(f):
            c = row.get("confidence", "")
            if c in ("", "None", None):
                continue
            conf.append(float(c))
            correct.append(row["exact_match"].strip().lower() == "true")
    if len(conf) < 10:
        print(f"need >=10 samples with confidence, got {len(conf)} "
              f"(run `evaluate` greedy — beam rows carry no confidence)")
        return 1
    art = calib.fit(conf, correct, method=args.method, n_bins=args.bins)
    calib.save(art, args.out)
    print(f"fit {args.method} on {art['n_samples']} samples: "
          f"ECE {art['ece_raw']:.4f} -> {art['ece_calibrated']:.4f} "
          f"({args.bins} bins) -> {args.out}")
    for r in art["reliability_calibrated"]:
        print(f"  [{r['bin_lo']:.1f},{r['bin_hi']:.1f}) n={r['count']:<5d} "
              f"conf={r['mean_confidence']:.3f} acc={r['accuracy']:.3f}")
    return 0


def cmd_serve(args) -> int:
    from .serve.app import run_server

    run_server(model_dir=args.model_dir, host=args.host, port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="handwritten_math_ocr_api_torch",
        description="PyTorch/CUDA handwritten math OCR framework")
    sub = p.add_subparsers(dest="command", required=True)
    encoders = ["swin_t", "resnet18", "res18trans"]

    bv = sub.add_parser("build-vocab", help="build vocab.json from labels")
    _common_data_args(bv)
    bv.add_argument("--include-val", action="store_true")
    bv.set_defaults(fn=cmd_build_vocab)

    tr = sub.add_parser("train", help="train a model")
    _common_data_args(tr)
    _device_arg(tr)
    tr.add_argument("--encoder", default="swin_t", choices=encoders)
    tr.add_argument("--batch-size", type=int, default=64)
    tr.add_argument("--num-workers", type=int, default=4,
                    help="loader threads assembling batches")
    tr.add_argument("--epochs", type=int, default=20)
    tr.add_argument("--learning-rate", type=float, default=3e-4)
    tr.add_argument("--warmup-steps", type=int, default=0)
    tr.add_argument("--early-stop-patience", type=int, default=5)
    tr.add_argument("--synthetic-stream", type=int, default=0, metavar="N",
                    help="train on an endless synthetic stream, N samples "
                         "an epoch (fresh formulas every epoch; the vocab "
                         "from the grammar)")
    tr.add_argument("--stream-renderer", default="typeset",
                    choices=["typeset", "stroke"],
                    help="synthetic-stream pixels: 'typeset' (font-rendered "
                         "LaTeX source) or 'stroke' (handwriting-style "
                         "structural layout, data/strokes.py)")
    tr.add_argument("--stream-hard", action="store_true",
                    help="extended symbol inventory, longer and deeper "
                         "formulas, and with the stroke renderer denser "
                         "layouts and degraded ink")
    tr.add_argument("--stream-max-tokens", type=int, default=60,
                    help="--stream-hard: formula length cap in tokens")
    tr.add_argument("--stream-native-render", action="store_true",
                    help="stroke renderer: the host C++ display-list "
                         "renderer (native/src/stroke_render.cpp; same "
                         "distribution, another random stream)")
    tr.add_argument("--stream-degrade", type=float, default=0.6,
                    help="--stream-hard + stroke renderer: ink degradation "
                         "strength in [0, 1]")
    tr.add_argument("--stream-envs", action="store_true",
                    help="stream 2-D LaTeX environments (matrix, cases); "
                         "fine-tuning a checkpoint without them needs "
                         "extend-vocab first")
    tr.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA decay of a shadow copy of the weights (0 = "
                         "off); the val pass and best model then use it")
    tr.add_argument("--resume-from", default=None)
    tr.add_argument("--mlflow-experiment", default=None)
    tr.add_argument("--init-from", default=None, metavar="ARTIFACT_DIR",
                    help="initialize shape-compatible param subtrees from a "
                         "serving artifact")
    tr.add_argument("--freeze-encoder-epochs", type=int, default=0,
                    help="hold the encoder fixed for the first N epochs")
    tr.add_argument("--encoder-lr-mult", type=float, default=1.0,
                    help="scale the encoder's updates (its own learning "
                         "rate under Adam); 1.0 = shared")
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("evaluate", help="evaluate on the test split")
    _common_data_args(ev)
    _device_arg(ev)
    ev.add_argument("--encoder", default="swin_t", choices=encoders)
    ev.add_argument("--checkpoint", default="best_model")
    ev.add_argument("--batch-size", type=int, default=64)
    ev.add_argument("--beam-size", type=int, default=None)
    ev.add_argument("--use-fused", action="store_true",
                    help="greedy and beam decode through the fused step "
                         "kernels")
    ev.add_argument("--use-ema", action="store_true",
                    help="evaluate the EMA weights of an --ema-decay "
                         "checkpoint (the raw weights if it has none)")
    ev.add_argument("--quantize", action="store_true",
                    help="int8 decoder weights")
    ev.add_argument("--constrained", action="store_true",
                    help="pushdown-constrained greedy decode: structurally "
                         "valid LaTeX (greedy only)")
    ev.add_argument("--out-dir", default="results")
    ev.set_defaults(fn=cmd_evaluate)

    pr = sub.add_parser("predict", help="predict one image")
    _common_data_args(pr)
    _device_arg(pr)
    pr.add_argument("image")
    pr.add_argument("--encoder", default="swin_t", choices=encoders)
    pr.add_argument("--checkpoint", default="best_model")
    pr.add_argument("--beam-size", type=int, default=None)
    pr.add_argument("--use-ema", action="store_true")
    pr.add_argument("--constrained", action="store_true",
                    help="pushdown-constrained greedy decode (greedy only)")
    pr.add_argument("--temperature", type=float, default=None,
                    help="sampled decode temperature (enables sampling)")
    pr.add_argument("--top-k", type=int, default=None,
                    help="sampled decode top-k filter")
    pr.add_argument("--top-p", type=float, default=None,
                    help="sampled decode nucleus filter")
    pr.add_argument("--seed", type=int, default=0)
    pr.set_defaults(fn=cmd_predict)

    ri = sub.add_parser("render-inkml", help="rasterize InkML to PNGs+CSV")
    ri.add_argument("inkml_dir")
    ri.add_argument("out_img_dir")
    ri.add_argument("out_csv")
    ri.add_argument("--limit", type=int, default=None)
    ri.set_defaults(fn=cmd_render_inkml)

    ms = sub.add_parser("make-synthetic", help="generate synthetic dataset")
    ms.add_argument("--data-root", default="data")
    ms.add_argument("--train", type=int, default=256)
    ms.add_argument("--val", type=int, default=64)
    ms.add_argument("--test", type=int, default=64)
    ms.set_defaults(fn=cmd_make_synthetic)

    mc = sub.add_parser("make-corpus",
                        help="generate a learnable corpus (images depict "
                             "their labels)")
    mc.add_argument("--data-root", default="data")
    mc.add_argument("--train", type=int, default=20000)
    mc.add_argument("--val", type=int, default=1000)
    mc.add_argument("--test", type=int, default=1000)
    mc.add_argument("--seed", type=int, default=0)
    mc.add_argument("--renderer", default="typeset",
                    choices=["typeset", "stroke"],
                    help="'stroke': handwriting-style structural renders "
                         "(data/strokes.py)")
    mc.add_argument("--hard", action="store_true",
                    help="stroke renderer: the MathWriting-difficulty "
                         "regime (matches train --stream-hard)")
    mc.add_argument("--max-tokens", type=int, default=60,
                    help="--hard: formula length cap")
    mc.add_argument("--degrade", type=float, default=0.6,
                    help="--hard: ink degradation strength in [0, 1]")
    mc.add_argument("--envs", action="store_true",
                    help="include 2-D environment formulas (stroke "
                         "renderer only)")
    mc.set_defaults(fn=cmd_make_corpus)

    xv = sub.add_parser("extend-vocab",
                        help="append tokens to a checkpoint's vocab and "
                             "resize its decoder head for fine-tuning")
    xv.add_argument("--checkpoint-dir", required=True)
    xv.add_argument("--checkpoint", default="best_model")
    xv.add_argument("--out-dir", required=True)
    xv.add_argument("--encoder", default="swin_t", choices=encoders)
    xv.add_argument("--model-overrides", default=None,
                    help="JSON ModelConfig overrides of the SOURCE model")
    xv.add_argument("--tokens", default=None,
                    help="comma-separated tokens to add (default: the 2-D "
                         "environment tokens, data.synthetic.ENV_TOKENS)")
    xv.add_argument("--seed", type=int, default=0)
    xv.set_defaults(fn=cmd_extend_vocab)

    gq = sub.add_parser("convert-gqa",
                        help="mean-pool MHA K/V heads into nhead_kv "
                             "groups for GQA fine-tuning")
    gq.add_argument("--checkpoint-dir", required=True)
    gq.add_argument("--checkpoint", default="best_model")
    gq.add_argument("--out-dir", required=True)
    gq.add_argument("--nhead-kv", type=int, required=True)
    gq.add_argument("--encoder", default="swin_t", choices=encoders)
    gq.add_argument("--model-overrides", default=None,
                    help="JSON ModelConfig overrides of the SOURCE model")
    gq.set_defaults(fn=cmd_convert_gqa)

    cv = sub.add_parser("convert-checkpoint",
                        help="convert a reference PyTorch .pth to a "
                             "serving artifact")
    cv.add_argument("pth")
    cv.add_argument("vocab", help="path to vocab.json")
    cv.add_argument("out_dir")
    cv.add_argument("--encoder", default="swin_t", choices=encoders)
    cv.add_argument("--model-overrides", default=None)
    cv.set_defaults(fn=cmd_convert)

    ce = sub.add_parser("convert-encoder",
                        help="convert a raw torchvision swin_t .pth "
                             "(ImageNet) to an encoder-only artifact for "
                             "train --init-from")
    ce.add_argument("pth")
    ce.add_argument("out_dir")
    ce.set_defaults(fn=cmd_convert_encoder)

    ex = sub.add_parser("export",
                        help="training checkpoint -> serving artifact")
    _common_data_args(ex)
    _device_arg(ex)
    ex.add_argument("out_dir")
    ex.add_argument("--encoder", default="swin_t", choices=encoders)
    ex.add_argument("--checkpoint", default="best_model")
    ex.add_argument("--use-ema", action="store_true",
                    help="export the EMA shadow weights when present")
    ex.set_defaults(fn=cmd_export)

    ca = sub.add_parser("calibrate",
                        help="fit a confidence calibrator from eval CSV")
    ca.add_argument("--results", required=True,
                    help="test_results.csv from `evaluate` (greedy)")
    ca.add_argument("--out", default="calibration.json")
    ca.add_argument("--method", default="platt",
                    choices=["platt", "isotonic"])
    ca.add_argument("--bins", type=int, default=10)
    ca.set_defaults(fn=cmd_calibrate)

    sv = sub.add_parser("serve", help="run the serving API")
    sv.add_argument("--model-dir", default="trained-model")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8080)
    sv.set_defaults(fn=cmd_serve)

    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
