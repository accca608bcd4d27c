"""Rank functions of the port's distributed training tests
(``tests/test_torch_train_mesh.py``), and their launcher.

``spawn(job, world, tmp_path)`` starts ``world`` processes (``spawn``
start method), each of which joins a gloo process group through a
``FileStore`` under ``tmp_path`` (no fixed port: several test workers run
at once) on the loopback interface, with one PyTorch thread a rank, runs
``JOBS[job](rank, tmp_path)`` and leaves the group; rank 0's result is
saved and returned. Every collective and the join have a timeout, so that
a stuck rank fails the test instead of hanging the run.
"""

import datetime
import os
import time

import numpy as np
import torch

TIMEOUT_S = 120

SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(1, 2), window_size=4)


def model_config(**kw):
    from handwritten_math_ocr_api_torch.core import config as tcfg

    fields = dict(img_h=32, img_w=80, d_model=32, nhead=4,
                  dim_feedforward=64, dropout=0.0, num_decoder_layers=2,
                  max_seq_len=12, vocab_size=20, dtype="float32",
                  memory_norm=True)
    swin = dict(SWIN, stochastic_depth=kw.pop("stochastic_depth", 0.0))
    return tcfg.ModelConfig(**{**fields, **kw},
                            swin=tcfg.SwinConfig(**swin))


def batch(b=8, seed=0, uint8=False):
    """(images, captions) of ``b`` rows: normalised float images, or uint8
    ones (augmented in the step); captions with PAD tails of several
    lengths."""
    rng = np.random.default_rng(seed)
    shape = (b, 32, 80, 1)
    images = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8 else
              rng.uniform(-1, 1, shape).astype(np.float32))
    caps = rng.integers(3, 20, (b, 12)).astype(np.int32)
    caps[:, 0] = 1
    caps[0, 8:] = 0
    caps[1, 5], caps[1, 6:] = 2, 0
    caps[b - 1, 3:] = 0
    return images, caps


def _leaves(t):
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.utils import tree

    return [x.detach().clone() for x in
            tree.leaves(mesh_lib.full_tensors(t))]


def _placements(x):
    """A DTensor's placements: ``"R"`` or the sharded dimension."""
    return ["R" if p.is_replicate() else p.dim for p in x.placements]


STEP_CASES = {
    # name: (model config fields, train config fields, uint8 images)
    "float": ({}, {}, False),
    "dropout": ({"dropout": 0.1, "stochastic_depth": 0.1}, {}, False),
    "uint8": ({}, {}, True),
    "ema": ({}, {"ema_decay": 0.9}, False),
}


def on_mesh(state, opt, mesh):
    """``state`` with its params (and EMA) sharded by ``TP_RULES`` and a
    fresh optimizer state over them committed to ``mesh``, as
    ``train_model`` places a state."""
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.utils import tree

    params = mesh_lib.shard_params(state.params, mesh)
    return state.replace(
        params=params,
        ema_params=(None if state.ema_params is None
                    else mesh_lib.shard_params(state.ema_params, mesh)),
        opt_state=mesh_lib.commit_to_mesh(opt.init(tree.leaves(params)),
                                          mesh))


def gradients(params, cfg, tc, images, caps):
    """The train step's gradients of ``params`` on float ``images`` with
    dropout off (its forward and loss, without the optimizer), whole."""
    from handwritten_math_ocr_api_torch.models import model as tmodel
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.train import losses
    from handwritten_math_ocr_api_torch.utils import tree

    with mesh_lib.step_scope(params):
        logits = tmodel.forward(params, cfg, images, caps,
                                generator=torch.Generator(), kernels=False)
        loss = losses.smoothed_cross_entropy(logits, caps[:, 1:], 0,
                                             tc.label_smoothing)
        grads = torch.autograd.grad(loss, tree.leaves(params))
    return [x.detach().clone() for x in mesh_lib.full_tensors(grads)]


def steps_job(rank, tmp_path):
    """On a 2 x 2 mesh: one train step of each ``STEP_CASES`` case, sharded
    and on one device (every rank runs both), and the float case's
    gradients; the placements ``TP_RULES`` gives; ``commit_to_mesh``."""
    from torch.distributed.tensor import DTensor

    from handwritten_math_ocr_api_torch.core import config as tcfg
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.train import optim as toptim
    from handwritten_math_ocr_api_torch.train import step as tstep
    from handwritten_math_ocr_api_torch.utils import tree

    mesh = mesh_lib.make_device_mesh(data=2, tensor=2)
    out = {}
    for name, (model_kw, train_kw, uint8) in STEP_CASES.items():
        cfg = model_config(**model_kw)
        tc = tcfg.TrainConfig(learning_rate=1e-3, **train_kw)
        images, caps = batch(uint8=uint8, seed=len(out))
        s1, opt = tstep.create_train_state(cfg, tc, 0, "cpu")
        s2, opt2 = tstep.create_train_state(cfg, tc, 0, "cpu")
        s2 = on_mesh(s2, opt2, mesh)
        si, sc = mesh_lib.shard_batch((images, caps), mesh)
        if name == "float":
            out["grads"] = (
                gradients(s1.params, cfg, tc, torch.from_numpy(images),
                          torch.from_numpy(caps).long()),
                gradients(s2.params, cfg, tc, si, sc.long()))
        s1, m1 = tstep.make_train_step(cfg, tc, opt, device="cpu")(
            s1, images, caps, 7)
        s2, m2 = tstep.make_train_step(cfg, tc, opt2, device="cpu")(
            s2, si, sc, 7)
        out[name] = {
            "loss": (float(m1["loss"]), float(m2["loss"].full_tensor())),
            "grad_norm": (float(m1["grad_norm"]),
                          float(m2["grad_norm"].full_tensor())),
            "params": (_leaves(s1.params), _leaves(s2.params)),
            "ema": (None if s1.ema_params is None else
                    (_leaves(s1.ema_params), _leaves(s2.ema_params))),
            "all_dtensors": all(isinstance(x, DTensor) for x in
                                tree.leaves(s2.params)
                                + tree.leaves(s2.opt_state)),
            "lr": toptim.get_learning_rate(s2.opt_state),
        }
    params = s2.params
    out["placements"] = {"/".join(p): _placements(x) for p, x in
                         zip(tree.paths(params), tree.leaves(params))}
    # commit_to_mesh: DTensors kept, tensors replicated, the rest as is
    dt = params["decoder"]["fc_out"]["w"]
    tree_in = {"w": dt, "count": torch.zeros((), dtype=torch.int32),
               "step": 3}
    committed = mesh_lib.commit_to_mesh(tree_in, mesh)
    mixed_raises = False
    try:
        dt + torch.ones(dt.shape)
    except RuntimeError:
        mixed_raises = True
    out["commit"] = {
        "kept": committed["w"] is dt,
        "count": _placements(committed["count"]),
        "step": committed["step"],
        "mixed_raises": mixed_raises,
        "committed_adds": float((committed["count"] + 1).full_tensor()),
    }
    return out


def loop_job(rank, tmp_path):
    """``train_model`` on 2 ranks (the loop builds the mesh): two steps of
    4 uint8 images each and a val batch of 3, checkpointed."""
    from handwritten_math_ocr_api_torch.train import loop as tloop

    cfg, train, val, tok = loop_setup(tmp_path)
    state = tloop.train_model(cfg, train, val, tok, device="cpu")
    return {"params": _leaves(state.params), "step": state.step,
            "ema": _leaves(state.ema_params)}


def loop_setup(tmp_path):
    """The config, loaders and tokenizer of ``loop_job`` (and of the
    one-device run the test holds it against)."""
    from handwritten_math_ocr_api_torch.core import config as tcfg
    from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer

    vocab = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
             **{f"t{i}": i for i in range(4, 20)}}
    train = []
    for seed in (11, 12):
        images, caps = batch(b=4, seed=seed, uint8=True)
        train.append({"image": images, "caption": caps})
    images, caps = batch(b=3, seed=13, uint8=True)
    val = [{"image": images, "caption": caps}]
    cfg = tcfg.Config(model=model_config(),
                      train=tcfg.TrainConfig(
                          epochs=1, learning_rate=1e-3, ema_decay=0.9,
                          checkpoint_every=1,
                          checkpoint_dir=os.path.join(str(tmp_path), "ck")))
    return cfg, train, val, Tokenizer(vocab)


def jax_job(rank, tmp_path):
    """One train step on a 2 x 2 mesh from the params that
    ``tmp_path/params.pt`` holds (the test makes them with JAX), on
    ``batch()``'s float images; its loss, gradient norm and params."""
    from handwritten_math_ocr_api_torch.core import config as tcfg
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.train import optim as toptim
    from handwritten_math_ocr_api_torch.train import step as tstep

    mesh = mesh_lib.make_device_mesh(data=2, tensor=2)
    tc = tcfg.TrainConfig(learning_rate=1e-3)
    opt = toptim.make_optimizer(tc)
    params = torch.load(os.path.join(tmp_path, "params.pt"))
    state = on_mesh(tstep.state_from_params(params, opt, tc), opt, mesh)
    images, caps = batch()
    state, m = tstep.make_train_step(model_config(), tc, opt, device="cpu")(
        state, *mesh_lib.shard_batch((images, caps), mesh), 0)
    return {"loss": float(m["loss"].full_tensor()),
            "grad_norm": float(m["grad_norm"].full_tensor()),
            "params": _leaves(state.params)}


def optimizer_job(rank, tmp_path):
    """The optimizer on a 2 x 2 mesh against the plain optimizer on the
    same gradients (gathered whole): with the gradients as the backward
    leaves them (partial sums on 'data') and placed as their params
    (``mesh.placed_like``, as the train step does). For each: the
    gradients' placements, and the leaves whose update or first moment
    differ by more than 5e-5, with the largest differences."""
    from handwritten_math_ocr_api_torch.core import config as tcfg
    from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
    from handwritten_math_ocr_api_torch.train import step as tstep
    from handwritten_math_ocr_api_torch.utils import tree

    mesh = mesh_lib.make_device_mesh(data=2, tensor=2)
    cfg, tc = model_config(), tcfg.TrainConfig(learning_rate=1e-3)
    images, caps = batch()
    si, sc = mesh_lib.shard_batch((images, caps), mesh)
    out = {}
    for placed in (False, True):
        state, opt = tstep.create_train_state(cfg, tc, 0, "cpu")
        state = on_mesh(state, opt, mesh)
        leaves = tree.leaves(state.params)
        with mesh_lib.step_scope(state.params):
            logits = tstep.model_mod.forward(state.params, cfg, si,
                                             sc.long(), kernels=False)
            loss = tstep.smoothed_cross_entropy(logits, sc.long()[:, 1:], 0,
                                                tc.label_smoothing)
            grads = list(torch.autograd.grad(loss, leaves))
        if placed:
            grads = mesh_lib.placed_like(grads, leaves)
        whole = [g.full_tensor().clone() for g in grads]
        plain = opt.init([x.full_tensor().detach() for x in leaves])
        ones = [1.0] * len(grads)
        with mesh_lib.step_scope(state.params):
            up, _ = opt.update(grads, state.opt_state, ones)
        up_plain, _ = opt.update(whole, plain, ones)
        off = []
        for i, path in enumerate(tree.paths(state.params)):
            du = float((up[i].full_tensor() - up_plain[i]).abs().max())
            dm = float((state.opt_state["mu"][i].full_tensor()
                        - plain["mu"][i]).abs().max())
            if max(du, dm) > 5e-5:
                off.append(("/".join(path), du, dm))
        out[placed] = {"placements": sorted({str(g.placements)
                                             for g in grads}),
                       "off": off, "leaves": len(grads)}
    return out


JOBS = {"steps": steps_job, "loop": loop_job, "jax": jax_job,
        "optimizer": optimizer_job}


def _rank(rank, world, store_path, out_path, job, tmp_path):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = JOBS[job](rank, tmp_path)
        if rank == 0:
            torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp_path):
    """Run ``JOBS[job]`` on ``world`` gloo ranks; rank 0's result."""
    import torch.multiprocessing as mp

    os.makedirs(tmp_path, exist_ok=True)
    store = os.path.join(str(tmp_path), f"{job}.store")
    out = os.path.join(str(tmp_path), f"{job}.pt")
    ctx = mp.start_processes(_rank, args=(world, store, out, job,
                                          str(tmp_path)),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job}: ranks still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out, weights_only=False)


def report(name, one, mesh, paths, grads=None, atol=5e-5, rtol=1e-4):
    """Print each leaf where ``mesh`` (tensors) passes the tests' tolerance
    of ``one``: its count of such elements out of its size and the largest
    error; with ``grads`` (one device's, the mesh's), also the largest
    one-device gradient magnitude at those elements and the largest
    gradient difference over the leaf."""
    bad = 0
    for i, (p, a, b) in enumerate(zip(paths, one, mesh)):
        over = (b - a).abs() > atol + rtol * a.abs()
        if not over.any():
            continue
        bad += 1
        line = (f"{name} {p}: {int(over.sum())}/{a.numel()} over, max err "
                f"{float((b - a).abs().max()):.3e}")
        if grads is not None:
            g1, g2 = grads[0][i], grads[1][i]
            line += (f", max |g| there {float(g1[over].abs().max()):.3e}, "
                     f"max grad diff {float((g2 - g1).abs().max()):.3e}")
        print(line)
    print(f"{name}: {bad} of {len(paths)} leaves over tolerance")


def main(out_dir):
    """The steps and loop jobs held against one device leaf by leaf, as the
    tests hold them, with each leaf over tolerance printed (the tests'
    comparisons without pytest or JAX), then the optimizer job."""
    from handwritten_math_ocr_api_torch.core import config as tcfg
    from handwritten_math_ocr_api_torch.train import loop as tloop
    from handwritten_math_ocr_api_torch.train import step as tstep

    print("torch", torch.__version__)
    template, _ = tstep.create_train_state(model_config(),
                                           tcfg.TrainConfig(), 0, "cpu")
    paths = ["/".join(p) for p in tloop.tree.paths(template.params)]
    steps = spawn("steps", 4, os.path.join(out_dir, "steps"))
    for case in STEP_CASES:
        r = steps[case]
        print(f"{case}: loss {r['loss']}, grad_norm {r['grad_norm']}")
        report(case, *r["params"], paths,
               grads=steps["grads"] if case == "float" else None)
    report("float grads", *steps["grads"], paths, atol=1e-6, rtol=1e-4)
    got = spawn("loop", 2, os.path.join(out_dir, "mesh"))
    cfg, train, val, tok = loop_setup(os.path.join(out_dir, "one"))
    want = tloop.train_model(cfg, train, val, tok, device="cpu")
    report("loop", [p.detach() for p in tloop.tree.leaves(want.params)],
           got["params"], paths)
    for placed, r in spawn("optimizer", 4,
                           os.path.join(out_dir, "optimizer")).items():
        name = "placed" if placed else "as the backward leaves them"
        print(f"optimizer on gradients {name} {r['placements']}: "
              f"{len(r['off'])} of {r['leaves']} leaves off by > 5e-5")
        for path, du, dm in r["off"]:
            print(f"  {path}: update {du:.3e}, first moment {dm:.3e}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1])
