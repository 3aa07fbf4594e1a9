"""The device scene generator: the port generator's statistics, the feed's
tile layout, and the same scene from the same seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lt_bench.gen import SceneStats, make_scene, plan_tiles

H = W = 128


def _fit_rate(years, dn, qa) -> float:
    from land_trendr_tpu_torch.ops.tile import process_tile_dn

    return float(process_tile_dn(years, dn, qa, index="nbr").seg.model_valid.float().mean())


def test_statistics_match_the_port_generator():
    """Disturbed share, cloud share and fit rate at the same spec (the
    port generator's defaults, 128² x 40 years), two seeds each."""
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack

    port, mine = [], []
    for seed in (1, 2):
        st = make_stack(SceneSpec(width=W, height=H, seed=seed))
        dn = {b: torch.from_numpy(np.ascontiguousarray(st.dn(b).reshape(40, -1).T))
              for b in ("nir", "swir2")}
        qa = torch.from_numpy(np.ascontiguousarray(st.qa.reshape(40, -1).T))
        port.append(((st.truth_year >= 0).mean(), ((st.qa & 8) != 0).mean(),
                     _fit_rate(torch.from_numpy(st.years), dn, qa)))
        sc = make_scene(W, H, 1984, 2023, H, ("nir", "swir2"), SceneStats(), seed, "cpu")
        d, q = sc.tile_inputs(0)
        mine.append((sc.disturbed_share, sc.cloud_share, _fit_rate(sc.years, d, q)))
    p, m = np.mean(port, axis=0), np.mean(mine, axis=0)
    assert m[0] == pytest.approx(p[0], abs=0.01)    # disturbed share, 0.3
    assert m[1] == pytest.approx(p[1], abs=0.003)   # cloud share, 0.08
    assert m[2] == pytest.approx(p[2], abs=0.015)   # fit rate, ~0.39
    qa_bits = q.view(torch.int16)
    assert int(((qa_bits & 8) != 0).sum()) == round(sc.cloud_share * H * W * 40)


def test_tile_layout_is_the_feeds():
    """Rows of a tile are ``iy * w + ix`` of its window, padded with DN 0
    and the QA fill bit; the fill strips give one margin a year across
    every tile, so the column of each row is the feed's."""
    h, w, tile = 50, 70, 32
    sc = make_scene(w, h, 1990, 1999, tile, ("nir", "red"), SceneStats(), 3, "cpu")
    assert sc.tiles == plan_tiles(h, w, tile) and len(sc.tiles) == 6
    assert sc.dn["nir"].shape == (6, tile * tile, 10) and sc.dn["nir"].dtype == torch.int16
    assert sc.qa.dtype == torch.uint16
    fill = torch.zeros(h, w, 10, dtype=torch.bool)
    for k, tw in enumerate(sc.tiles):
        qa = sc.qa[k].view(torch.int16)
        assert (qa[tw.px:] == 1).all() and (sc.dn["nir"][k, tw.px:] == 0).all()
        fill[tw.y0:tw.y0 + tw.h, tw.x0:tw.x0 + tw.w] = (qa[:tw.px] & 1).bool().reshape(tw.h, tw.w, 10)
        assert (sc.dn["red"][k, :tw.px][(qa[:tw.px] & 1).bool()] == 0).all()
    for y in range(10):
        cols = fill[:, :, y]
        assert (cols == cols[:1]).all()  # a strip of whole columns
        m = int(cols[0, : w // 2].sum())
        assert cols[0, :m].all() and not cols[0, m : w - m].any() and cols[0, w - m :].all()


def test_same_seed_same_scene():
    a = make_scene(40, 30, 1984, 2023, 16, ("nir",), SceneStats(), 2**31 + 3, "cpu")
    b = make_scene(40, 30, 1984, 2023, 16, ("nir",), SceneStats(), 2**31 + 3, "cpu")
    c = make_scene(40, 30, 1984, 2023, 16, ("nir",), SceneStats(), 2**31 + 4, "cpu")
    assert torch.equal(a.dn["nir"], b.dn["nir"]) and torch.equal(a.qa, b.qa)
    assert not torch.equal(a.dn["nir"], c.dn["nir"])
