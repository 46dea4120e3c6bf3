"""The card's float32 rule for the fused steps' jvp under each choice of
its references: ``python -m repro_torch.tools.jvp_rule_margins`` (on the
card; PYTHONPATH=src).

``jvp_checks.hold_on_card`` holds a fused step's float32 tangents row by
row against a float64 truth, within twice a float32 floor's error plus the
tolerance.  For every ``fused_step`` and ``fused_step_poly`` case at
vdp_table3's shape and full_width's (``chip_smoke.FULL_WIDTH_KINDS``'
tolerance shape and mask kind), this prints the Function's margin (a row's
error over its bound, the largest; above 1 refuses) with the floor taken
from the plain op's jvp or from ``card_plain_jvp`` (the plain tangent
formula at the kernel's forward bits), and the truth from the plain op's
float64 jvp or ``card_plain_jvp``'s: one JSON line.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import grad_checks, jvp_checks, workloads

# chip_smoke.FULL_WIDTH_KINDS: the one tolerance shape and mask kind its
# full-width cases take.
FULL_WIDTH_KINDS = dict(tol_kinds=("scalar",), mask_kinds=("run3",))


def margins(device, shapes=(("vdp_table3", workloads.VDP, {}),
                            ("full_width", workloads.FULL, FULL_WIDTH_KINDS))):
    rows = []
    for shape, shp, kinds in shapes:
        for case in grad_checks.cases(shp["b"], shp["f"], shp["n"], np.float32,
                                      ops=grad_checks.FUSED, **kinds):
            op = case["op"]
            tans = jvp_checks.tangents(case, 0, device=device)
            tans64 = {k: tuple(t.double() for t in v) if isinstance(v, tuple) else v.double()
                      for k, v in tans.items()}
            case64 = grad_checks.as_float64(case)
            _, got = jvp_checks.case_jvp(case, grad_checks.function(op), device, tans)
            floors = {"plain": jvp_checks.case_jvp(case, grad_checks.plain(op), device, tans),
                      "card_plain": jvp_checks.card_plain_jvp(case, device, tans)}
            truths = {"plain64": jvp_checks.case_jvp(case64, grad_checks.plain(op), device,
                                                     tans64),
                      "card_plain64": jvp_checks.card_plain_jvp(case64, device, tans64)}
            keyed = lambda ts: {f"out{i}": t for i, t in enumerate(ts)}  # noqa: E731
            rows.append(dict(shape=shape, op=op, case=case["label"], margins={
                f"{a}/{b}": grad_checks.hold_to_float64(
                    case["label"], keyed(got), keyed(fl[1]), keyed(tr[1]), torch.float32,
                    check=False)
                for a, fl in floors.items() for b, tr in truths.items()}))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("jvp_rule_margins: no CUDA device is available")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"jvp_rule_margins": margins(torch.device("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
