"""Seeded photo-like RGB images, made with torch on any device.

An image is a colour field whose power spectrum falls as 1/f^slope (1/f^2
is the statistics of natural images), flat objects with hard edges drawn
over it (ellipses and rectangles, radii drawn log-uniformly), and mild
Gaussian sensor noise.  Work happens in YCbCr (JFIF) and converts to RGB
at the end.  Each content class is a dict of parameters, read from the
traffic file:

  luma_mean, luma_sigma       the luma field
  cb_mean, cr_mean            the colour cast (offsets from neutral)
  chroma_sigma                the chroma fields' spread
  objects                     objects an image
  object_radius [lo, hi]      radius range, a share of the shorter side
  object_luma [lo, hi]        object luma, uniform
  object_chroma [lo, hi]      object Cb and Cr offsets from the cast, uniform
  noise_sigma                 sensor noise, per RGB channel (luma only
                              when chroma_sigma, object_chroma and the
                              cast are all 0)

A batch holds a fixed count of images of each class; the seed draws the
content and the order of the classes.
"""

import math

import torch


def _amplitude(fy: torch.Tensor, fx: torch.Tensor, floor: float,
               slope: float) -> torch.Tensor:
    f = torch.sqrt(fx[None, :] ** 2 + fy[:, None] ** 2).clamp_min(floor)
    amp = f.pow(-slope / 2.0)
    amp[0, 0] = 0.0
    return amp


def _spectral_filter(h: int, w: int, slope: float, device) -> torch.Tensor:
    """The half spectrum's amplitudes, scaled so that a field's expected
    variance is 1: the seed changes the content, not its energy."""
    floor = 1.0 / max(h, w)
    full = _amplitude(torch.fft.fftfreq(h, dtype=torch.float64),
                      torch.fft.fftfreq(w, dtype=torch.float64), floor, slope)
    scale = float((full ** 2).mean().sqrt())
    half = _amplitude(torch.fft.fftfreq(h, device=device),
                      torch.fft.rfftfreq(w, device=device), floor, slope)
    return half / scale


def fields(n: int, h: int, w: int, slope: float, gen: torch.Generator,
           device) -> torch.Tensor:
    """[n, h, w] float32 fields with a 1/f^slope power spectrum, zero mean
    and an expected variance of 1."""
    noise = torch.randn((n, h, w), generator=gen, device=device)
    spec = torch.fft.rfft2(noise, norm="ortho")
    return torch.fft.irfft2(spec * _spectral_filter(h, w, slope, device),
                            s=(h, w), norm="ortho")


def _draw_objects(ycc: torch.Tensor, cls: dict, gen: torch.Generator):
    """Objects painted over one image's [3, h, w] YCbCr planes, in place."""
    _, h, w = ycc.shape
    k = int(cls["objects"])
    if k == 0:
        return
    u = torch.rand((k, 8), generator=gen, device=ycc.device,
                   dtype=torch.float64).tolist()
    lo, hi = cls["object_radius"]
    ylo, yhi = cls["object_luma"]
    clo, chi = cls["object_chroma"]
    side = min(h, w)
    for cx, cy, rr, asp, yy, cb, cr, shape in u:
        r = side * lo * math.exp(rr * math.log(hi / lo))
        ry = max(r * math.exp((asp - 0.5) * math.log(4.0)), 1.0)
        rx = max(r * r / ry, 1.0)
        x0, x1 = int(cx * w - rx), int(cx * w + rx) + 1
        y0, y1 = int(cy * h - ry), int(cy * h + ry) + 1
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if x1 <= x0 or y1 <= y0:
            continue
        colour = torch.tensor(
            [ylo + yy * (yhi - ylo),
             cls["cb_mean"] + clo + cb * (chi - clo),
             cls["cr_mean"] + clo + cr * (chi - clo)],
            device=ycc.device)[:, None, None]
        patch = ycc[:, y0:y1, x0:x1]
        if shape < 0.5:                          # rectangle
            patch.copy_(colour.expand_as(patch))
            continue
        ys = (torch.arange(y0, y1, device=ycc.device) + 0.5 - cy * h) / ry
        xs = (torch.arange(x0, x1, device=ycc.device) + 0.5 - cx * w) / rx
        inside = (ys[:, None] ** 2 + xs[None, :] ** 2) <= 1.0
        patch.copy_(torch.where(inside, colour, patch))


def _ycc_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[:, 0], ycc[:, 1], ycc[:, 2]
    return torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                        y + 1.772 * cb], dim=-1)


def images(classes: dict, counts: dict, h: int, w: int, slope: float,
           gen: torch.Generator, device) -> tuple:
    """(uint8 [n, h, w, 3] RGB on `device`, [class name of each image]):
    counts[name] images of each class, in an order drawn from `gen`."""
    names = [name for name in sorted(counts) for _ in range(counts[name])]
    order = torch.randperm(len(names), generator=gen, device=device).tolist()
    names = [names[i] for i in order]
    out = torch.empty((len(names), h, w, 3), dtype=torch.uint8,
                      device=device)
    for i, name in enumerate(names):
        cls = classes[name]
        f = fields(3, h, w, slope, gen, device)
        ycc = torch.stack([cls["luma_mean"] + cls["luma_sigma"] * f[0],
                           cls["cb_mean"] + cls["chroma_sigma"] * f[1],
                           cls["cr_mean"] + cls["chroma_sigma"] * f[2]])
        _draw_objects(ycc, cls, gen)
        colour = (cls["chroma_sigma"] or cls["cb_mean"] or cls["cr_mean"]
                  or any(cls["object_chroma"]))
        sigma = cls["noise_sigma"]
        if colour:
            rgb = _ycc_to_rgb(ycc[None])[0]
            rgb += sigma * torch.randn(rgb.shape, generator=gen,
                                       device=device)
        else:
            y = ycc[0] + sigma * torch.randn(ycc[0].shape, generator=gen,
                                             device=device)
            rgb = y[..., None].expand(h, w, 3)
        out[i] = rgb.round().clamp(0, 255).to(torch.uint8)
    return out, names


def pool(traffic: dict, seed: int, device) -> list:
    """traffic["pool"] distinct host inputs, each a uint8 [n, h, w, 3]
    batch holding traffic["counts"] images of each class, drawn from the
    seed on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = []
    for _ in range(traffic["pool"]):
        imgs, _ = images(traffic["classes"], traffic["counts"],
                         traffic["height"], traffic["width"],
                         traffic["slope"], gen, device)
        out.append(imgs.cpu().numpy())
    return out
