"""POP (Projection onto Orthogonal Prototypes) core, in fp32.

Port of segland_tpu/ops/pop.py.  Every classifier conv is bias-free and
ReLU is positively homogeneous, so the classifier applied to a rank-1
component ``p * s_k`` collapses to ``max(p,0)*alpha_k + max(-p,0)*beta_k``
with per-class scalars computed once.  The reference's [B,K,C,N] component
tensor never exists and the classifier runs once, on the background
residual.

Layout as in the JAX package: feature maps are [B,h,w,C], classifier
weights are input-major dense mats (w1, w2 [C,C], w3 [C]).
"""

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2): x / max(||x||_2, eps)."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def proto_similarity(emb_a: torch.Tensor, emb_b: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine similarities: sim(a, a) [K,K], or sim(a, a ++ b) [Ka, Ka+Kb]."""
    a = l2_normalize(emb_a.float())
    if emb_b is None:
        return a @ a.T
    b = l2_normalize(emb_b.float())
    return a @ torch.cat([a, b], 0).T


def classifier_scalars(emb_hat, w1, w2, w3):
    """(alpha [K], beta [K]) with classifier(p * s_k) == max(p,0)*alpha_k +
    max(-p,0)*beta_k, for L2-normalized prototypes emb_hat [K,C]."""
    v = emb_hat @ w1
    alpha = torch.relu(torch.relu(v) @ w2) @ w3
    beta = torch.relu(torch.relu(-v) @ w2) @ w3
    return alpha, beta


def classifier_apply(x, w1, w2, w3):
    """Full classifier pass on a [..., C] feature map -> [...] logit."""
    h = torch.relu(x @ w1)
    h = torch.relu(h @ w2)
    return h @ w3


def _rank1(proj, alpha, beta):
    return torch.relu(proj) * alpha + torch.relu(-proj) * beta


def pop_logits_base(feats, emb_b, w1, w2, w3):
    """forward_base logits: [B,h,w,C] -> [B,h,w,1+Kb], [bg, base...]."""
    q = feats.float()
    s = l2_normalize(emb_b.float())
    proj = torch.einsum("bhwc,kc->bhwk", q, s)
    bg_feats = q - torch.einsum("bhwk,kc->bhwc", proj, s)
    alpha, beta = classifier_scalars(s, w1, w2, w3)
    bg = classifier_apply(bg_feats, w1, w2, w3)
    return torch.cat([bg[..., None], _rank1(proj, alpha, beta)], -1)


def pop_logits_all(feats, emb_b, emb_n, wb, wn):
    """forward_all logits [B,h,w,1+Kb+Kn] = [bg, base..., novel...] and the
    novel-head sub-logits [B,h,w,1+Kn] = [bg, novel...].  Base components are
    scored by the base classifier ``wb``; background and novel by ``wn``."""
    q = feats.float()
    sb = l2_normalize(emb_b.float())
    sn = l2_normalize(emb_n.float())
    proj_b = torch.einsum("bhwc,kc->bhwk", q, sb)
    proj_n = torch.einsum("bhwc,kc->bhwk", q, sn)
    bg_feats = (q - torch.einsum("bhwk,kc->bhwc", proj_b, sb)
                - torch.einsum("bhwk,kc->bhwc", proj_n, sn))
    fg_b = _rank1(proj_b, *classifier_scalars(sb, *wb))
    fg_n = _rank1(proj_n, *classifier_scalars(sn, *wn))
    bg = classifier_apply(bg_feats, *wn)[..., None]
    return torch.cat([bg, fg_b, fg_n], -1), torch.cat([bg, fg_n], -1)
