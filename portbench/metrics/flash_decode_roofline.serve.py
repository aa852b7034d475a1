"""Flash attention in the decode steps of the traced wave: the least time of
its calls from their shapes over the device time of their launches
(``flash_decode_kernel``), in %.  A decode step (a ``serve.decode`` span)
calls it once a layer over every row of the batch, riding retired rows
included; row b attends over the keys at slots 0..pos[b], so the call reads
the step's ``keys`` key and value rows once, q and the output once, and the
cache's positions (``max_len`` of them) and the rows' positions once."""
from portbench import yardstick


def least_ms(cfg: dict, keys: int, rows: int, slots: int, esize: int = 2) -> float:
    """One decode call over ``rows`` rows that visit ``keys`` keys in all,
    in a cache of ``slots`` slots: 4 K operations a (row, key) pair and
    query head."""
    H, G, K = cfg["num_attention_heads"], cfg["num_key_value_heads"], yardstick.head_dim(cfg)
    moved = 2 * keys * G * K * esize + 2 * rows * H * K * esize + 4 * slots + 4 * rows
    return yardstick.least_ms(moved, 4 * K * H * keys)


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    steps = [s for s in session() if s.name == "serve.decode" and "keys" in s.attrs]
    if r.trace is None or not steps:
        return None
    least = [least_ms(r.cfg, s.attrs["keys"], s.attrs["rows"], r.mix["max_len"]) for s in steps]
    calls = [ms for ms in least for _ in range(r.cfg["num_hidden_layers"])]
    return yardstick.roofline_share(calls, r.trace.kernels("flash_decode_kernel"))
