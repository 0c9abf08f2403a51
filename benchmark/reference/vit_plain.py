"""The ViT forward in plain float32 PyTorch operations.

It follows the published ViT (pre-LN encoder layers, a class token, learned
position embeddings, exact erf GELU, softmax attention with D^-1/2 scaling)
and reads a state dict with the port's parameter names
(``benchmark/weights.py``). Images are NHWC; patches are flattened in
(row, column, channel) order, the layout of the port's patch projection.

``precision='fp8'`` is the control: every operand of every matrix product
(the projections, Q K^T and P V, the head) is rounded to float8 e4m3 with
one scale a tensor (its largest magnitude to 448) before the product, which
then runs in float32. Gradients pass the rounding unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
_E4M3_MAX = 448.0


def exact_fp32() -> None:
    """float32 products without TF32, set before the reference runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class PlainViT:
    """The forward of one state dict. ``params`` maps names to float32
    tensors (leaves that may require grad)."""

    def __init__(self, params: dict[str, torch.Tensor], shape: dict,
                 precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.p = params
        self.s = shape
        self.q = _fp8 if precision == "fp8" else (lambda x: x)

    def _linear(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        return self.q(x) @ self.q(w).t() + b

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.p[name + ".weight"],
                            self.p[name + ".bias"], self.s["eps"])

    def _attention(self, x, pre):
        b, n, c = x.shape
        h = self.s["heads"]
        d = c // h
        qkv = self._linear(x, pre + "attn.qkv").reshape(b, n, 3, h, d)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (B, H, N, D)
        s = (self.q(q) @ self.q(k).transpose(-1, -2)) * d ** -0.5
        o = self.q(torch.softmax(s, dim=-1)) @ self.q(v)
        o = o.transpose(1, 2).reshape(b, n, c)
        return self._linear(o, pre + "attn.out")

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) normalised float32 images -> (B, classes) logits."""
        s = self.s
        b, size, _, ch = images.shape
        p = s["patch"]
        g = size // p
        x = images.reshape(b, g, p, g, p, ch).permute(0, 1, 3, 2, 4, 5)
        x = self._linear(x.reshape(b, g * g, p * p * ch), "patch_embed.proj")
        cls = self.p["cls_token"].expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.p["pos_embed"]
        for i in range(s["layers"]):
            pre = f"layer.{i}."
            x = x + self._attention(self._ln(x, pre + "ln1"), pre)
            h = F.gelu(self._linear(self._ln(x, pre + "ln2"), pre + "mlp.fc1"))
            x = x + self._linear(h, pre + "mlp.fc2")
        x = self._ln(x, "final_ln")
        return self._linear(x[:, 0], "head")


@torch.no_grad()
def logits_in_blocks(model: PlainViT, images: torch.Tensor,
                     block: int = 32) -> torch.Tensor:
    """The logits of many images, ``block`` rows at a time."""
    return torch.cat([model.logits(images[i:i + block])
                      for i in range(0, images.shape[0], block)])
