"""``correct``: the plain reference against the program at a small size on
the CPU, the control (the reference with float8 weights) coming out not
correct, a route below the configuration's precision refused, and a run
with its timed path broken underneath coming out not correct: a token
altered where it is produced, and half of a batch's rows left out (their
answers taken from the other half)."""

import time

import pb_tiny
import pytest
import torch

import run as R
from harness import faults, load

LIMITS = {"mean_gap": 1e-4, "mean_conf_err": 1e-4, "unparsed": 0,
          "failed": 0}


@pytest.fixture(autouse=True)
def small(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(R, "config_limits", lambda name: LIMITS)
    monkeypatch.setattr(load, "GRACE_S", 20.0)


def bulk_cell(**kw):
    return pb_tiny.tiny_cell("bulk_closed", clients=3, images_per_request=4,
                             warm_buckets=[16],
                             engine={"max_batch_size": 12}, **kw)


def execute(cell, fault=None, seed=2 ** 31 + 5):
    return R.execute(cell.name, seed, 2.0, False, device="cpu", cell=cell,
                     t_process=time.perf_counter(), fault=fault)


def test_the_program_agrees_with_the_reference():
    res = execute(bulk_cell())
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_gap"]["value"] <= 1e-5
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_route_below_the_configurations_precision_is_refused():
    """The int8 decoder weights on a configuration that states float32:
    no limit can tell them apart, so the run is refused."""
    cell = bulk_cell()
    cell.traffic["route"] = dict(cell.traffic["route"], quantize=True)
    with pytest.raises(R.Refused):
        execute(cell)
    cell.config["decode_weights"] = "int8"      # stated: it runs
    assert execute(cell)["attempted"] > 0


def test_an_altered_token_is_not_correct():
    res = execute(bulk_cell(), fault=faults.altered_token)
    assert not res["correct"]


def test_half_the_batch_left_out_is_not_correct():
    res = execute(bulk_cell(), fault=faults.half_batch)
    assert not res["correct"]


def test_the_fp8_reference_control_is_not_correct():
    """The control that decides the limits: the reference with float8
    weights in the program's place, on the same answers, judged against
    the same limits."""
    res = R.execute("tiny", 2 ** 31 + 9, 2.0, False, device="cpu",
                    cell=bulk_cell(), t_process=time.perf_counter(),
                    control=True)
    assert res["correct"]
    assert res["control_correct"] is False
    assert set(res["control_checks"]) == set(res["checks"])
