"""`engine.encode_pipelined` over an endless iterator of the pool's
batches: a request is one batch, timed from when the iterator hands it over
to when its result is yielded.  Once the window's seconds are up the
iterator ends and the batches in flight complete."""


def drive(engine, param, pool, traffic, window, device) -> None:
    handed = {}

    def batches():
        i = 0
        while window.more():
            handed[i] = window.begin(i)
            yield pool[i % len(pool)]
            i += 1

    stream = engine.encode_pipelined(batches(), param,
                                     depth=traffic["depth"], device=device)
    for i, out in enumerate(stream):
        window.end(i, i % len(pool), handed.pop(i), out)
