"""The plain reference: its acceleration against a test of every
triangle, its frames against the program's CPU path, and its control
(TF32) failing the comparison."""

import json
import os

import numpy as np
import pytest
import torch

from rtbench import judge, port, reference, scenes, spec
from rtbench.traffic import Traffic

CACHE = os.path.join(spec.HERE, ".cache")


def grid(n=2, sub=2):
    return scenes.make({"generator": "instanced_grid", "n": n,
                        "base": {"generator": "icosphere",
                                 "subdivisions": sub}}, CACHE)


def ico(sub):
    return scenes.make({"generator": "icosphere", "subdivisions": sub},
                       CACHE)


def brute_nearest(ar, s, o, d):
    t_all = []
    for tri in range(s.p1.shape[0]):
        idx = torch.full((o.shape[0],), tri, dtype=torch.int64)
        valid, t, _, _, _ = reference._intersect(ar, s, o, d, idx)
        t_all.append(torch.where(valid, t, torch.inf))
    t_all = torch.stack(t_all, 1)
    t, tri = t_all.min(1)
    return t, torch.where(torch.isfinite(t), tri, -1)


def test_accel_finds_what_every_triangle_finds():
    sc = grid(2, 1)
    s = reference.soup(sc, "cpu")
    acc = reference.build(s)
    gen = torch.Generator().manual_seed(0)
    n = 600
    o = torch.tensor(sc.cam_pos).expand(n, 3).clone()
    o += torch.randn(n, 3, generator=gen, dtype=torch.float64)
    d = -o + torch.randn(n, 3, generator=gen, dtype=torch.float64) * 2
    d = d / d.norm(dim=1, keepdim=True)
    ar = reference.Arith()
    t, tri, _, _, _ = reference.nearest(ar, acc, o, d, chunk=128)
    want_t, want_tri = brute_nearest(ar, s, o, d)
    assert int((tri >= 0).sum()) > 50
    assert torch.equal(tri, want_tri)
    assert torch.equal(t[tri >= 0], want_t[tri >= 0])
    tmax = torch.rand(n, generator=gen, dtype=torch.float64) * 60
    occ = reference.occluded(ar, acc, o, d, tmax, chunk=128)
    assert torch.equal(occ, want_t <= tmax)


def port_frame(sc, w, h, pose, cards=1):
    """The program's frame on the CPU (eager stages), uint8."""
    from distributed_raytracer_tpu_torch.runtime import framebuffer

    cfg = {"width": w, "height": h, "renderer": {}}
    name = "single" if cards == 1 else "bands"
    layout = spec.load_module("layouts", name).build(port.scene(sc), cfg,
                                                     "cpu", cards)
    img = layout.render(port.camera(pose), True)
    return framebuffer.to_u8_device(img)


@pytest.mark.parametrize("scene,cards", [("ico4", 1), ("grid3", 1),
                                         ("grid3", 2)])
def test_reference_matches_the_program_on_the_cpu(scene, cards):
    sc = ico(4) if scene == "ico4" else grid(3, 2)
    w, h = 64, 48
    t = Traffic(spec._json("traffic", "orbit"), sc, w)
    acc = reference.build(reference.soup(sc, "cpu"))
    for k in (0, 5, len(t.cycle) // 3):
        pose = t.poses[k + 1]
        want, code = judge.reference_frame(acc, pose, w, h)
        got = port_frame(sc, w, h, pose, cards)
        assert int((code > 0).sum()) > 100          # the scene is in view
        numbers = judge.compare(got, want, code)
        assert numbers["bad_share"] <= 1e-3, numbers
        assert numbers["mean_abs"] <= 0.5, numbers


@pytest.mark.parametrize("config", ["ico9-640", "grid12-4k"])
def test_control_fails(config):
    """The reference in TF32 in the program's place fails a number of the
    configuration's check, on its scene cut to a CPU's size."""
    with open(os.path.join(spec.HERE, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    sc = ico(6) if config == "ico9-640" else grid(4, 3)
    w, h = 96, 72
    acc = reference.build(reference.soup(sc, "cpu"))
    t = Traffic(spec._json("traffic", "orbit"), sc, w)
    pose = t.poses[7]
    want, code = judge.reference_frame(acc, pose, w, h)
    got, _ = judge.reference_frame(acc, pose, w, h, reference.Arith("tf32"))
    numbers = judge.compare(got, want, code)
    limits = cfg["check"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
