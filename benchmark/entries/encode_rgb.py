"""A request is one `engine.encode_rgb` call on one host image."""


def drive(engine, param, pool, traffic, window, device) -> None:
    i = 0
    while window.more():
        item = i % len(pool)
        t0 = window.begin(i)
        out = engine.encode_rgb(pool[item][0], param, device=device)
        window.end(i, item, t0, [out])
        i += 1
