"""KFW tcn_fold_weights (skip mode): norm2's fold into [out_w | skip_w] for
all blocks in one launch: the f32 weights read, the folded weights written
in the activation dtype, gamma2 / beta2 read and their folded terms over
B + Sc columns written; a multiply and two multiply-adds per element."""


def work(s, n):
    nb, h, bs = s["NB"], s["H"], s["B"] + s["Sc"]
    by = nb * h * bs * (4 + s["it"]) + 2 * nb * (h + bs) * 4
    return n * by, n * 5.0 * nb * h * bs, "float32"
