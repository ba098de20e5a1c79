"""A request is one `engine.encode_batch` call on a host batch."""


def drive(engine, param, pool, traffic, window, device) -> None:
    i = 0
    while window.more():
        item = i % len(pool)
        t0 = window.begin(i)
        out = engine.encode_batch(pool[item], param, device=device)
        window.end(i, item, t0, out)
        i += 1
