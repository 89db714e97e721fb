"""Stage-B inputs as the query path hands them to ``build_selective_lut``
(numpy and torch only, so the card tests can use them on a machine without
JAX).

``qsub`` (Q, np, S, 2) is a strided view, never a contiguous array:
``sliced`` takes it out of a wider array (inner stride 3 and a probe
offset), ``expanded`` broadcasts one row a query over the probes (a probe
stride of 0, as ``core/juno.py:_stage_b`` builds ip's ``qsub``). τ keeps
nothing in its first row and everything in its last.
"""
import numpy as np
import torch

FORMS = ("sliced", "expanded")


def qsub_view(seed, form, q=3, n_probe=4, s=8, e=32, device="cpu"):
    """Returns ``(qsub, entries, entry_sq, tau)`` on ``device``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    if form == "sliced":
        qsub = t(rng.standard_normal((q, n_probe + 1, s, 3)) * 2)[:, 1:, :, 1:]
    elif form == "expanded":
        qsub = t(rng.standard_normal((q, 1, s, 2)) * 2).expand(q, n_probe, s, 2)
    else:
        raise ValueError(form)
    entries = t(rng.standard_normal((s, e, 2)))
    entry_sq = entries[..., 0] * entries[..., 0] + entries[..., 1] * entries[..., 1]
    tau = np.abs(rng.standard_normal((q, n_probe, s))) * 2
    tau[0, 0] = 0.0                      # a row that keeps nothing
    tau[-1, -1] = 1e3                    # a row that keeps everything
    return qsub, entries, entry_sq, t(tau)


def contiguous_planes(qsub, entries, tau):
    """The same inputs as contiguous (B, S) and (S, E) planes:
    ``(q0, q1, e0, e1, tau)``."""
    s = qsub.shape[-2]
    return (qsub[..., 0].reshape(-1, s).contiguous(),
            qsub[..., 1].reshape(-1, s).contiguous(),
            entries[..., 0].contiguous(), entries[..., 1].contiguous(),
            tau.reshape(-1, s).contiguous())
