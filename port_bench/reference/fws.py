"""FWS in plain PyTorch, float64: the zygosity and FWS statistics of
KGL_Gene's PfEMP analysis (kga_analytic/kga_PfEMP/kga_analysis_PfEMP_FWS.h:
15-52, kga_analysis_PfEMP_heterozygous.h:35,97) over a subset of genomes,
written from their definitions. It imports nothing of the port.

A genome's code at a biallelic variant is 0 (not carried), 1
(heterozygous) or 2 (homozygous for the alternate allele). Over the n
genomes of the subset:

  variant    het, hom: the subset's genomes with code 1, with code 2;
             p = (het + 2 hom) / (2 n), the alternate allele's frequency;
             hs = 2 p (1 - p), the population's expected heterozygosity;
             its bin: the b of the 11 AlleleFrequencyBins with
             lo_b <= p < hi_b (0-0.05, 0.05-0.10, ..., 0.45-0.50, 0.50-1.00001);
  genome     for each bin, its loci there with code 1 and with code 2;
             Hw, its heterozygous loci; Hs, the sum of hs over the loci it
             carries (code 1 or 2); FWS = 1 - Hw / Hs, and 1 where Hs is 0.

Departures from the FWS of the literature (Manske et al., Nature 2012,
487:375-379), as KGL_Gene computes it: Hw and Hs are summed over the bins,
not fitted by a regression of per-bin heterozygosities; Hw counts
heterozygous calls, not a fraction of them; p is the subset's own, from
its codes, with no published AF column. A variant no genome of the subset
carries has p = 0 and adds nothing; the program leaves it out of its
per-variant output, as a view of the subset's own variants would, and its
counts here are 0.

The statistics work in blocks of VARIANT_BLOCK variants, so that on the
card they fit beside the program; `dtype` sets the precision of p, hs and
the Hs sums (the benchmark's control computes them in float32).
"""

from __future__ import annotations

import torch

__all__ = ["FREQUENCY_BINS", "VARIANT_BLOCK", "statistics"]

FREQUENCY_BINS = ((0.00, 0.05), (0.05, 0.10), (0.10, 0.15), (0.15, 0.20), (0.20, 0.25),
                  (0.25, 0.30), (0.30, 0.35), (0.35, 0.40), (0.40, 0.45), (0.45, 0.50),
                  (0.50, 1.00001))
VARIANT_BLOCK = 8192


def statistics(codes: torch.Tensor, index, dtype=torch.float64,
               block: int = VARIANT_BLOCK) -> dict:
    """The subset `index` (genome columns of codes (V, G) uint8) as a dict of
    tensors on the codes' device: variant_het, variant_hom (V,) int64;
    af, hs (V,) and bins (V,) int64; het_bins, hom_bins (n, 11) int64;
    het, hom (n,) int64; hs_sum, fws (n,) in `dtype`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = codes.device
    V = codes.shape[0]
    idx = torch.as_tensor(index, dtype=torch.int64, device=dev)
    n = idx.shape[0]
    out = {"variant_het": torch.zeros(V, dtype=torch.int64, device=dev),
           "variant_hom": torch.zeros(V, dtype=torch.int64, device=dev),
           "af": torch.zeros(V, dtype=dtype, device=dev),
           "hs": torch.zeros(V, dtype=dtype, device=dev),
           "bins": torch.zeros(V, dtype=torch.int64, device=dev),
           "het_bins": torch.zeros((n, len(FREQUENCY_BINS)), dtype=torch.int64, device=dev),
           "hom_bins": torch.zeros((n, len(FREQUENCY_BINS)), dtype=torch.int64, device=dev),
           "hs_sum": torch.zeros(n, dtype=dtype, device=dev)}
    for v0 in range(0, V, block):
        v1 = min(V, v0 + block)
        z = codes[v0:v1].index_select(1, idx)
        het, hom = z == 1, z == 2
        het_v, hom_v = het.sum(1), hom.sum(1)
        p = (het_v + 2 * hom_v).to(dtype) / (2 * n) if n else torch.zeros(v1 - v0, dtype=dtype,
                                                                          device=dev)
        hs = 2 * p * (1 - p)
        out["variant_het"][v0:v1], out["variant_hom"][v0:v1] = het_v, hom_v
        out["af"][v0:v1], out["hs"][v0:v1] = p, hs
        for b, (lo, hi) in enumerate(FREQUENCY_BINS):
            rows = (p >= lo) & (p < hi)
            out["bins"][v0:v1][rows] = b
            out["het_bins"][:, b] += het[rows].sum(0)
            out["hom_bins"][:, b] += hom[rows].sum(0)
        out["hs_sum"] += hs @ (het | hom).to(dtype)
    out["het"], out["hom"] = out["het_bins"].sum(1), out["hom_bins"].sum(1)
    hs_sum = out["hs_sum"]
    out["fws"] = torch.where(hs_sum > 0, 1 - out["het"] / hs_sum, torch.ones_like(hs_sum))
    return out
