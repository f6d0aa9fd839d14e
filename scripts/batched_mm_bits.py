"""Whether a batched product gives each lane the bits of the 2-D product,
on an NVIDIA GPU: the kmg V-cycle's deflation product (D x D by D x B, D =
10) as a fleet makes it (one batch of T = 4) against one GP's 2-D call, at
B = 1, 2, 3, 4, 8, 32 columns, and at B = 1 the formulations that could
stand in for the 2-D one. A fleet's lane differs from its standalone GP
only where they differ (``chip_smoke.py::_batched_products``).

    python scripts/batched_mm_bits.py
"""
import torch


def main():
    T, D = 4, 10
    g = torch.Generator(device="cuda").manual_seed(0)
    M = torch.randn(T, D, D, dtype=torch.float64, device="cuda", generator=g)
    for B in (1, 2, 3, 4, 8, 32):
        y = torch.randn(T, D, B, dtype=torch.float64, device="cuda",
                        generator=g)
        single = [M[t] @ y[t] for t in range(T)]
        batched = M @ y
        one = [(M[t][None] @ y[t][None])[0] for t in range(T)]
        gap = max(float((batched[t] - single[t]).abs().max())
                  for t in range(T))
        print(f"B={B}: batch of {T} bitwise "
              f"{all(torch.equal(batched[t], single[t]) for t in range(T))}"
              f" (max abs gap {gap:.3e}); batch of 1 bitwise "
              f"{all(torch.equal(one[t], single[t]) for t in range(T))}",
              flush=True)
    # at B = 1, over random draws of two dimensions D
    for D in (3, 10):
        hits = {"pad to 2 columns": 0, "multiply and sum": 0}
        trials = 300
        for _ in range(trials):
            sc = torch.exp(3 * torch.randn(T, D, D, dtype=torch.float64,
                                           device="cuda", generator=g))
            M = torch.randn(T, D, D, dtype=torch.float64, device="cuda",
                            generator=g) * sc
            y = torch.randn(T, D, 1, dtype=torch.float64, device="cuda",
                            generator=g) * 1e3
            single = torch.stack([M[t] @ y[t] for t in range(T)])
            pad = (M @ torch.cat([y, torch.zeros_like(y)], -1))[..., :1]
            ms = (M[..., :, :, None] * y[..., None, :, :]).sum(-2)
            hits["pad to 2 columns"] += bool(torch.equal(pad, single))
            hits["multiply and sum"] += bool(torch.equal(ms, single))
        print(f"D={D}, B=1, {trials} draws, equal to the 2-D product: "
              + ", ".join(f"{k} {v}" for k, v in hits.items()), flush=True)


if __name__ == "__main__":
    main()
