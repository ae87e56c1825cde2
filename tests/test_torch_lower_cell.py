"""`launch.steps.lower_cell`'s `meta` against the reference's, whose
`lower_cell` runs in a subprocess on 512 forced host devices with Auto
axes (`torch_mesh_reference`): the FSDP rule (>= 8 GB of bf16), the
residual rule, the mesh and the microbatch count. Tier-1 holds
qwen3-0.6b `train_4k`, mixtral-8x7b `train_4k` and granite-moe
`decode_32k` on the 16 x 16 mesh; `slow` holds every applicable cell on
both production meshes. The port's plan runs on the mesh's sizes alone.
"""
import pytest

from repro_torch.configs import SHAPES, get_config, list_archs, skip_reason
from repro_torch.launch.steps import lower_cell
from torch_mesh_reference import run_reference

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
FAST = [("qwen3-0.6b", "train_4k", False), ("mixtral-8x7b", "train_4k", False),
        ("granite-moe-3b-a800m", "decode_32k", False)]
ALL = [(a, s, mp) for mp in (False, True) for a in list_archs()
       for s in SHAPES if not skip_reason(a, s)]


def _metas(cells, tmp_path_factory):
    return run_reference({"lower": cells}, 512,
                         tmp_path_factory.mktemp("lower"),
                         timeout=1200)["lower"]


@pytest.fixture(scope="module")
def fast_metas(tmp_path_factory):
    return _metas(FAST, tmp_path_factory)


@pytest.fixture(scope="module")
def all_metas(tmp_path_factory):
    return _metas(ALL, tmp_path_factory)


def _port_meta(cell):
    arch, shape, multi_pod = cell
    plan, meta, step = lower_cell(get_config(arch), SHAPES[shape],
                                  MESHES[multi_pod])
    assert set(plan) >= {"params", "batch", "rules"}
    assert (step is None) == (SHAPES[shape].kind == "train" or arch in (
        "recurrentgemma-2b", "whisper-tiny"))
    assert ("opt" in plan) == (SHAPES[shape].kind == "train")
    assert ("cache" in plan) == (SHAPES[shape].kind == "decode")
    return meta


@pytest.mark.parametrize("cell", FAST, ids=["-".join(map(str, c))
                                            for c in FAST])
def test_meta_matches_reference(fast_metas, cell):
    assert _port_meta(cell) == fast_metas[cell]


@pytest.mark.slow
@pytest.mark.parametrize("cell", ALL, ids=["-".join(map(str, c))
                                           for c in ALL])
def test_meta_matches_reference_every_cell(all_metas, cell):
    assert _port_meta(cell) == all_metas[cell]
