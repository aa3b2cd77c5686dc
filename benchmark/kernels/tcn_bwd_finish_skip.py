"""KF tcn_bwd_finish (skip mode): every block's weight gradients finished
once a step, skip_w's included: at the least one float32 partial read and
the gradient written per element (in_w, out_w, skip_w, dw_w, the four norm
affines, the two PReLU slopes), one add each."""


def work(s, n):
    per_block = 2 * s["B"] * s["H"] + s["Sc"] * s["H"] + s["P"] * s["H"] + 4 * s["H"] + 2
    elems = s["NB"] * per_block
    return 2 * 4 * elems, float(elems), "float32"
