"""Faults planted in the system under test, to show that the comparison
that decides ``correct`` catches them (``readings.py --mode <fault>``
on the card; ``tests/test_portbench_faults.py`` on the CPU)."""

from __future__ import annotations


def unchanged(gan) -> None:
    """Every optimizer step returns its state unchanged."""
    for opt in (gan.g_opt, gan.d_opt, gan.vd_opt):
        if opt is not None:
            opt.step = lambda *a, **k: None


def half_batch(gan) -> None:
    """Each step sees half of its batch; its losses are the mean over the
    rest."""
    builder = gan.builder
    d_step, g_step = builder.d_step, builder.g_step

    def half(t):
        if t is None:
            return None
        if t.dim() >= 2 and t.shape[0] == 1:  # (accum, mb, ...)
            return t[:, : t.shape[1] // 2]
        return t[: t.shape[0] // 2]

    def d_half(real, *, text_encodings=None, text_embeds=None, **kw):
        return d_step(half(real), text_encodings=half(text_encodings),
                      text_embeds=half(text_embeds), **kw)

    def g_half(batch, *, text_encodings=None, text_embeds=None, **kw):
        if isinstance(batch, int):
            batch = batch // 2
        return g_step(batch, text_encodings=half(text_encodings),
                      text_embeds=half(text_embeds), **kw)

    builder.d_step, builder.g_step = d_half, g_half


def altered(gan) -> None:
    """One pixel of every sample altered where it is produced: set to the
    negative of the sample's largest value."""
    generate = gan.generate

    def altered_generate(*a, **k):
        out = generate(*a, **k)
        out[:, 0, 0, :] = -abs(out).max()
        return out

    gan.generate = altered_generate


FAULTS = {"unchanged": unchanged, "half-batch": half_batch,
          "altered": altered}
