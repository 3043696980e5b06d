"""The model step's share of the card's dense bfloat16 peak, in %: the
matrix products every pass of the model UDF in the steady part of the
window must do (2 per weight each real token multiplies, the head at
the positions whose logits are taken, the scans' and attention's
products by the frozen formulas), over that time, at 989 TFLOP/s."""
from harness.window import steady_calls
from harness.work import PEAK_FLOP_S


def read(run):
    cfg = run.config["model"]
    total = 0
    for call in steady_calls(run):
        for rows, new, offset, heads in call["passes"]:
            total += run.model.products(cfg, rows, new, offset, heads)
    if total == 0:
        return None
    return 100.0 * total / (run.steady_s * PEAK_FLOP_S)
