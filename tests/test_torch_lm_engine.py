"""``repro_torch.serve.engine.ServeEngine`` against
``repro.serve.engine.ServeEngine``: fixed slots, per-slot positions,
prefill-as-decode, slots freed and re-admitted, a request stopped at
``max_seq - 1``. Both engines get the same model (SMOKE phi4-mini, and
SMOKE h2o-danube for the sliding-window ring; the reference's
``init_params`` carried across) and the same six queued requests (mixed
prompt lengths and ``max_new``, token ids from a numpy seed) on 4 slots,
and tick in lockstep.

Every request's ``out`` must equal the reference's. A divergence is
allowed only at a near-tie, and is listed: the port's top-2 logit gap at
that tick must be below twice the logits' tolerance (if both sides are
within ``tol`` of the true logits and pick different tokens, the gap is
at most ``2 tol``): 1e-5 in f32 (the reference's own rtol, times the
largest logit's magnitude), 2^-5 of the largest magnitude in bf16 (four
bf16 ulps at the top, ``test_torch_lm.py``'s model tolerance). After a
divergence that request's stream is not compared. After ``run`` the
caches are compared (f32: rtol 1e-5; bf16: 2^-5 of the largest
magnitude), leaving out the rows written after a listed divergence (the
whole slot of a sliding-window ring).
"""
import numpy as np
import pytest
import torch

from _torch_parity import engine_lockstep
from repro_torch import configs as PC
from repro_torch.models import get_model
from repro_torch.models import params as PPm
from repro_torch.serve import engine as PE

N_SLOTS = 4
# (prompt length, max_new): 6 requests on 4 slots, so two slots are freed
# and re-admitted; the 25-token prompt stops at max_seq - 1 = 31 before
# its max_new
REQUESTS = [(5, 6), (12, 3), (3, 8), (9, 4), (25, 12), (7, 7)]
MAX_SEQ = {"phi4_mini_3_8b": 32, "h2o_danube_3_4b": 48}
# h2o-danube's 32-token window wraps: prompts past it run the ring
SWA_REQUESTS = [(5, 6), (36, 5), (3, 8), (9, 4), (40, 6), (7, 7)]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def lockstep(arch: str, dtype: str):
    spec = SWA_REQUESTS if arch == "h2o_danube_3_4b" else REQUESTS
    return engine_lockstep(arch, dtype, spec, n_slots=N_SLOTS,
                           max_seq=MAX_SEQ[arch], tol=TOL[dtype])


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "h2o_danube_3_4b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_reference(arch, dtype):
    r_reqs, p_reqs, ref, port, rec, diverged = lockstep(arch, dtype)
    # the listing: request -> (output index, tick, slot, position, gap)
    print(f"{arch} {dtype} near-tie divergences: {diverged}")
    if dtype == "float32":
        assert not diverged, diverged       # none on these seeds
    for r, p in zip(r_reqs, p_reqs):
        assert p.done and r.done
        if p.rid not in diverged:
            assert p.out == r.out, (p.rid, p.out, r.out)
    # a slot's rows are compared up to the first position a listed
    # divergence wrote in it (later requests in that slot inherit it)
    first_bad = {}
    for _, _, slot, pos, _ in diverged.values():
        first_bad[slot] = min(first_bad.get(slot, 10 ** 9), pos + 1)
    for name in ("k", "v"):
        got = port.cache["blocks"][name].float().numpy()
        want = np.asarray(ref.cache["blocks"][name], np.float32)
        keep = np.ones(got.shape[1:3], bool)          # (slots, positions)
        for slot, pos in first_bad.items():
            # a ring (sliding window) rewrites every slot; a full cache
            # the positions from the divergence on
            keep[slot, 0 if "kpos" in port.cache["blocks"] else pos:] = False
        got, want = got[:, keep], want[:, keep]
        scale = float(np.abs(want).max())
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            assert float(np.abs(got - want).max()) <= TOL[dtype] * scale
    if "kpos" in port.cache["blocks"]:
        # positions are schedule, not values: equal even after a divergence
        np.testing.assert_array_equal(port.cache["blocks"]["kpos"].numpy(),
                                      np.asarray(ref.cache["blocks"]["kpos"]))
    assert max(int(p.max()) for _, p, _ in rec.ticks) < MAX_SEQ[arch]


def test_engine_replays_through_decode():
    """The outputs equal a replay of the same tick schedule through
    ``api.decode`` on a fresh cache, bit for bit (the check
    ``chip_smoke.py``'s ``lm.phi4_mini`` makes on the card)."""
    _, p_reqs, _, port, rec, _ = lockstep("phi4_mini_3_8b", "float32")
    model, params = port.model, port.params
    cache = PPm.init_params(model.cache_schema(N_SLOTS, port.max_seq),
                            device="cpu")
    for token, pos, logits in rec.ticks:
        got, cache = rec.decode(params, cache, token, pos)
        assert torch.equal(got, logits)
    assert sum(len(p.out) for p in p_reqs) == sum(
        min(m, MAX_SEQ["phi4_mini_3_8b"] - n) for n, m in REQUESTS)


def test_engine_run_and_empty_step():
    pc = PC.get_smoke_config("phi4_mini_3_8b")
    model = get_model(pc)
    params = PPm.init_params(model.schema, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = PE.ServeEngine(model, params, n_slots=2, max_seq=16, device="cpu")
    assert eng.step() == 0
    reqs = [PE.Request(rid=i, prompt=[1, 2, 3], max_new=2) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    ticks = eng.run()
    # two slots: requests 0 and 1 take 4 ticks, then request 2 takes 4
    assert ticks == 8
    assert all(r.done and len(r.out) == 2 for r in reqs)
    assert [r.slot for r in reqs] == [0, 1, 0]
