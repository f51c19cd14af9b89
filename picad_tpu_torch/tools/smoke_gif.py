"""Eval-loader GIF smoke: dump one eval sample (and its h-flip) as GIFs.

Counterpart of tools/smoke_gif.py, on the port's data path: the runnable
form of the reference eval loader's `__main__` smoke
(ucf_dataloader_eval.py:163-187: orig_XX_gt.gif / flip_XX_gt.gif for a
visual check of a whole-video eval sample), plus the sample's first
frame with its mask as a PNG.  Runs on the synthetic source: no
dataset, no card.  Needs matplotlib and imageio.

    python -m picad_tpu_torch.tools.smoke_gif [outdir] [index]
"""

from __future__ import annotations

import os
import sys
import tempfile

from picad_tpu_torch.data.dataset import EvalVideoDataset
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.utils.visualize import dump_clip_gif, overlay2


def main(argv=None) -> str:
    """Write the GIFs and the PNG into outdir (default: a directory
    under the system's temporary directory); returns outdir."""
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join(tempfile.gettempdir(), "picad_gif_smoke")
    index = int(argv[1]) if len(argv) > 1 else 0
    os.makedirs(outdir, exist_ok=True)

    ds = EvalVideoDataset(SyntheticVideoSource(8, num_classes=24, seed=7), clip_shape=(224, 224))
    print(len(ds))
    video, mask, label = ds[index]
    print(video.shape, mask.shape, label)

    dump_clip_gif(video, f"{outdir}/orig_{index:02d}_gt.gif", stride=2)
    # the eval path evaluates the h-flipped clip too (evaluate_ucf101.py's
    # flip stream); dump it as the reference smoke does
    dump_clip_gif(video[:, :, ::-1], f"{outdir}/flip_{index:02d}_gt.gif", stride=2)
    overlay2(mask[0, ..., 0], video[0], save=f"{outdir}/overlay_{index:02d}.png")
    print("Done for", index, "->", outdir)
    return outdir


if __name__ == "__main__":
    main()
