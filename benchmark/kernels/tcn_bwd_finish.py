"""KF tcn_bwd_finish: every block's weight gradients finished once a step,
whatever the number of launches that carry them: at the least one float32
partial read and the gradient written per element (in_w, out_w, dw_w, the
four norm affines, the two PReLU slopes), one add each. The partials the
producers' tiles leave (several per element) are the port's choice and
are not counted."""


def work(s, n):
    per_block = 2 * s["B"] * s["H"] + s["P"] * s["H"] + 4 * s["H"] + 2
    elems = s["NB"] * per_block
    return 2 * 4 * elems, float(elems), "float32"
