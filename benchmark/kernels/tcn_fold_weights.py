"""KFW tcn_fold_weights: norm2's fold into out_w for all blocks in one
launch: the f32 out_w read, the folded weights written in the activation
dtype, gamma2 / beta2 read and their folded terms written; a multiply and
two multiply-adds per element, in float32."""


def work(s, n):
    nb, h, b = s["NB"], s["H"], s["B"]
    by = nb * h * b * (4 + s["it"]) + 2 * nb * (h + b) * 4
    return n * by, n * 5.0 * nb * h * b, "float32"
