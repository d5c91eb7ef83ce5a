"""A configuration's file against the program's ``Config``: every key is
one of its fields, and the seeded weights have the program's tree."""

import glob
import os

import pytest

from benchmark.harness import common
from benchmark.harness import weights as W

FILES = sorted(glob.glob(os.path.join(common.BENCH, "configs", "*.json")))


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_config_keys_are_the_programs(path):
    from uwcv_tpu_torch.config import Config

    conf = common.load_json(path)
    cfg = Config.from_dict(conf["config"])
    for section, values in conf["config"].items():
        for k, v in values.items():
            got = getattr(getattr(cfg, section), k)
            want = v
            norm = lambda x: [norm(y) for y in x] if isinstance(
                x, (list, tuple)) else x
            assert norm(got) == norm(want), (section, k)
    for k in conf["reduced"]:
        assert k in conf["source_values"] and k in conf["assumed"]


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_weight_tree_is_the_programs(path):
    from uwcv_tpu_torch.config import Config
    from uwcv_tpu_torch.weights import flax_param_shapes

    conf = common.load_json(path)
    cfg = Config.from_dict(conf["config"])
    assert W.shapes(conf["config"]["model"]) == {
        k: tuple(v) for k, v in flax_param_shapes(cfg.model).items()}


def test_weights_repeat_from_the_seed():
    import torch

    m = common.load_json(FILES[0])["config"]["model"]
    tiny = dict(m, depth=26, fpn_channels=16, box_fc_dim=16)
    init = common.load_json(FILES[0])["init"]
    a = W.make(tiny, init, 2**31 + 11, torch.device("cpu"))
    b = W.make(tiny, init, 2**31 + 11, torch.device("cpu"))
    c = W.make(tiny, init, 2**31 + 12, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["params/fpn/output_p2/kernel"],
                           c["params/fpn/output_p2/kernel"])
