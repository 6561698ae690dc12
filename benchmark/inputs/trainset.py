"""The global trainer's resident training set from a seed, made on the
device in the compact layout the trainer holds (uint8 clean images, bf16
tokens, integer boundary distances, float32 boundary depths), written
nowhere.

Tokens are uniform in [-1, 1] (the 19 normalised features of each image);
the clean images are blocks of 8 x 8 pixels of one colour, the same scene
in both images; boundary distances are integers in [0, max_dist); boundary
depths are zero except on a share ``edge_share`` of the pixels, where they
lie in ``z_range``. Calls nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# samples made by one draw of each array
_CHUNK = 500


def make_trainset(seed: int, n: int, H: int, L: int, spec: dict, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    z0, z1 = spec["z_range"]
    out = {"input_param": torch.empty((n, 2, L, 19), dtype=torch.bfloat16, device=device),
           "imgs_u8": torch.empty((n, 2, H, H, 3), dtype=torch.uint8, device=device),
           "bndry_dist": torch.empty((n, H, H), dtype=torch.int32, device=device),
           "bndry_depth": torch.empty((n, H, H), dtype=torch.float32, device=device)}
    blocks = -(-H // 8)
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        out["input_param"][s:s + m] = (torch.rand((m, 2, L, 19), generator=g, device=device)
                                       * 2.0 - 1.0).to(torch.bfloat16)
        low = torch.randint(0, 256, (m, 3, blocks, blocks), generator=g, device=device,
                            dtype=torch.uint8)
        img = F.interpolate(low.float(), scale_factor=8, mode="nearest")[:, :, :H, :H]
        out["imgs_u8"][s:s + m] = img.permute(0, 2, 3, 1)[:, None].to(torch.uint8)
        out["bndry_dist"][s:s + m] = torch.randint(0, spec["max_dist"], (m, H, H), generator=g,
                                                   device=device, dtype=torch.int32)
        edge = torch.rand((m, H, H), generator=g, device=device) < spec["edge_share"]
        z = z0 + (z1 - z0) * torch.rand((m, H, H), generator=g, device=device)
        out["bndry_depth"][s:s + m] = torch.where(edge, z, 0.0)
    return out
