"""The port's roofline analysis against the reference's, on the CPU.

- `model_flops` for every config x every shape, equal to the reference's.
- `roofline()` equal to the reference's, the reference's constants set
  to the port's H100 figures for the comparison.
- `OpCounter`'s collective bytes and counts: functional collectives on a
  fake 4-rank process group of the shapes of the reference's HLO fixture
  (`tests/test_analysis.py`) give what the reference's
  `collective_bytes` gives for that HLO.
- FLOPs and bytes of plain and DTensor ops, views skipped, and the peak
  of live storage.
"""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import Shard, distribute_tensor  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    AR_FACTOR,
    HBM_BW,
    LINK_BW,
    PEAK_BF16,
    CellCosts,
    OpCounter,
    model_flops,
    roofline,
)
from repro_torch.configs import ARCHITECTURES, SHAPES, get_config  # noqa: E402

# the package exports a function of the same name as the module
ref_roofline = importlib.import_module("repro.analysis.roofline")

#: the reference's fixture, `tests/test_analysis.py`
HLO = """
ENTRY %main {
  %p0 = bf16[16,128]{1,0} parameter(0)
  %ag = bf16[256,128]{1,0} all-gather(bf16[16,128]{1,0} %p0), dimensions={0}
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), to_apply=%add
  %ars = f32[512]{0} all-reduce-start(f32[512]{0} %y), to_apply=%add
  %ard = f32[512]{0} all-reduce-done(f32[512]{0} %ars)
  %rs = bf16[8,64]{1,0} reduce-scatter(bf16[128,64]{1,0} %z), dimensions={0}
  %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%a, %b), dimensions={0}
  %cp = u32[2]{0} collective-permute(u32[2]{0} %c), source_target_pairs={{0,1}}
  %notacoll = f32[99]{0} add(f32[99]{0} %d, f32[99]{0} %e)
}
"""


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_model_flops_equal_the_reference(arch, shape):
    assert model_flops(get_config(arch), SHAPES[shape]) == ref_roofline.model_flops(
        ref_config(arch), REF_SHAPES[shape])


def test_constants_are_the_h100s():
    assert (PEAK_BF16, HBM_BW, LINK_BW, AR_FACTOR) == (989e12, 3.35e12, 50e9, 2.0)
    assert (PEAK_BF16, HBM_BW) != (ref_roofline.PEAK_BF16, ref_roofline.HBM_BW)


@pytest.mark.parametrize("costs", [
    dict(flops=197e12, bytes_accessed=819e9, coll_bytes=100e9),
    dict(flops=3.1e15, bytes_accessed=2e9, coll_bytes=1e6),
    dict(flops=1e9, bytes_accessed=4e13, coll_bytes=0.0),
    dict(flops=0.0, bytes_accessed=0.0, coll_bytes=0.0),
])
def test_roofline_equals_the_reference(monkeypatch, costs):
    monkeypatch.setattr(ref_roofline, "PEAK_BF16", PEAK_BF16)
    monkeypatch.setattr(ref_roofline, "HBM_BW", HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", LINK_BW)
    for n_chips, mf in ((256, 1.7e17), (512, 3.3e16)):
        want = ref_roofline.roofline(ref_roofline.CellCosts(**costs), n_chips, mf)
        got = roofline(CellCosts(**costs), n_chips, mf)
        assert got.as_dict() == want.as_dict()


@pytest.fixture
def fake_group4():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        yield dist.group.WORLD.group_name
    finally:
        dist.destroy_process_group()


def test_collectives_equal_the_reference_hlo(fake_group4):
    """One functional collective for each instruction of the fixture (each
    waited on); the waits and the permute's send are not counted, as the
    reference skips an async op's ``-done``."""
    want = ref_roofline.collective_bytes(HLO)
    want_counts = want.pop("_counts")
    group = fake_group4
    c10d = torch.ops._c10d_functional
    counter = OpCounter()
    wait = c10d.wait_tensor
    with counter:
        wait(c10d.all_gather_into_tensor(torch.zeros(64, 128, dtype=torch.bfloat16), 4,
                                         group))
        wait(c10d.all_reduce(torch.zeros(1024), "sum", group))
        wait(c10d.all_reduce(torch.zeros(512), "sum", group))
        wait(c10d.reduce_scatter_tensor(torch.zeros(32, 64, dtype=torch.bfloat16), "sum",
                                        4, group))
        wait(c10d.all_to_all_single(torch.zeros(8, 4), [2, 2, 2, 2], [2, 2, 2, 2],
                                    group))
        wait(c10d.isend(torch.zeros(2, dtype=torch.uint32), 1, 0, group))
        wait(c10d.irecv(torch.zeros(2, dtype=torch.uint32), 1, 0, group))
        torch.zeros(99) + torch.zeros(99)
    costs = CellCosts.from_counter(counter)
    assert costs.coll_by_kind == pytest.approx(want)
    assert costs.coll_counts == want_counts
    assert costs.coll_bytes == sum(want.values())


def test_flops_and_bytes_of_plain_ops():
    counter = OpCounter()
    y_bytes = 64 * 3072 * 4
    with FakeTensorMode():
        a, b = torch.zeros(64, 768), torch.zeros(768, 3072)
        counter.known([a, b])
        with counter:
            y = a @ b
            y.view(-1)  # a view moves nothing
            z = (y + 1).sum()
    assert counter.flops == 2 * 64 * 768 * 3072
    mm = (64 * 768 + 768 * 3072) * 4 + y_bytes
    assert counter.bytes_accessed == mm + 2 * y_bytes + (y_bytes + 4)
    # y, y + 1 and z live together at the sum; a and b were there before
    assert counter.peak_bytes == 2 * y_bytes + 4
    assert counter.coll_counts == dict.fromkeys(counter.coll_counts, 0)
    del y, z


def test_a_dtensor_op_counts_its_local_shard(fake_group4):
    """[64, 768] @ [768, 3072], the rows split over the first dim of a
    (2, 2) mesh: `FlopCounterMode` counts the global product,
    `OpCounter` this rank's [32, 768] @ [768, 3072]."""
    from torch.distributed.tensor import Replicate
    from torch.utils.flop_counter import FlopCounterMode

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("a", "b"))
    counter, flop_counter = OpCounter(), FlopCounterMode(display=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.zeros(64, 768), mesh, (Shard(0), Replicate()))
        w = distribute_tensor(torch.zeros(768, 3072), mesh, (Replicate(), Replicate()))
        with counter:
            y = torch.mm(x, w)
        with flop_counter:
            torch.mm(x, w)
    assert y.to_local().shape == (32, 3072)
    assert counter.flops == 2 * 32 * 768 * 3072
    assert flop_counter.get_total_flops() == 2 * 64 * 768 * 3072
    assert counter.bytes_accessed == (32 * 768 + 768 * 3072 + 32 * 3072) * 4


def test_cell_costs_fields_are_the_references():
    names = [f.name for f in dataclasses.fields(CellCosts)]
    assert names == [f.name for f in dataclasses.fields(ref_roofline.CellCosts)]
