"""The port's memory plan (ray_tpu_torch.models.memory_plan.plan_llama)
against the JAX package's, which it copies: the same accounting, so the
same numbers. Plain Python on both sides; the byte counts are exact and
each side rounds to 1e-3 GiB, so the results must be equal."""

import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.models import memory_plan as jplan
from ray_tpu_torch.models import llama, memory_plan

_SHAPES = {
    # chip_smoke.py's train and memory phases: bench.py's configuration
    # on one card, bf16 moments.
    "1b b4 s2048 bf16 moments": ("llama3_1b", {"data": 1},
                                 dict(batch_per_chip=4, seq_len=2048,
                                      moment_dtype_bytes=2)),
    # The reference's north star, sharded (f32 moments).
    "8b fsdp16 tensor4 b4 s2048": ("llama3_8b",
                                   {"data": 1, "fsdp": 16, "tensor": 4},
                                   dict(batch_per_chip=4, seq_len=2048)),
}


@pytest.mark.parametrize("remat", [False, True, "gate", "mlp"], ids=str)
@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_plan_llama_matches_the_reference(shape, remat):
    preset, mesh, kw = _SHAPES[shape]
    got = memory_plan.plan_llama(getattr(llama.LlamaConfig, preset)(), mesh,
                                 remat=remat, **kw)
    ref = jplan.plan_llama(getattr(jllama.LlamaConfig, preset)(), mesh,
                           remat=remat, **kw)
    assert got["per_chip_gib"] == ref["per_chip_gib"]
    for key in ("config", "mesh", "chips", "batch_per_chip", "seq_len",
                "global_tokens_per_step"):
        assert got[key] == ref[key], key
    assert set(got) == set(ref)


def test_plan_names_the_h100():
    """The plan's device is the port's card: 80 GiB of HBM for an H100;
    Llama-3.2-1B at batch 4 x 2048 fits one card at every remat mode,
    Llama-3-8B unsharded does not."""
    kw = dict(batch_per_chip=4, seq_len=2048, moment_dtype_bytes=2)
    for remat in (False, True, "gate", "mlp"):
        plan = memory_plan.plan_llama(llama.LlamaConfig.llama3_1b(),
                                      {"data": 1}, remat=remat, **kw)
        assert plan["chip"] == "h100" and plan["hbm_gib"] == 80.0
        assert plan["fits"]
        assert abs(plan["utilization"]
                   - plan["per_chip_gib"]["total"] / 80.0) < 1e-3
    solo = memory_plan.plan_llama(llama.LlamaConfig.llama3_8b(), {"data": 1},
                                  batch_per_chip=4, seq_len=2048)
    assert not solo["fits"]
