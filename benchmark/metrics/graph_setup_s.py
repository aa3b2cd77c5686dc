"""graph_setup_s: seconds of the run that the port's graph layer spent in
its eager calls, its capture warm-ups and its captures (models/graphed.
counts(): eager_ns + capture_ns; the streaming separator's captures count
there too), the kernels' builds and loads at first use included: the part
of set-up that only the program can shorten. Nothing to read where the
port keeps no such counter or captured nothing (the CPU)."""


def read(name, trace, ctx):
    from convtasnet_torch.models import graphed

    c = graphed.counts()
    if "capture_ns" not in c or not c["captures"]:
        return None
    return (c["eager_ns"] + c["capture_ns"]) * 1e-9
