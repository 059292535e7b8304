"""Video -> per-frame PNG extraction with aspect-preserving resize, or a
remux to a Motion-JPEG mp4.

Counterpart of ``nerf_qa_tpu/tools/convert_video.py``. Reference
behaviour: conver_video.py / conver_video2.py — mp4 -> frame PNGs under
<video>/original_size + resized subdirs (conver_video2.py:39-58),
aspect-preserving resize helper (:17-37), ad-hoc PSNR/DISTS sanity check
(conver_video.py:62-102). Host-only: no device is touched.

Examples:
  python -m nerf_qa_torch.tools.convert_video --video clip.mp4 --out-dir frames
  python -m nerf_qa_torch.tools.convert_video --video frames_dir --to-mp4 clip.mp4
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from nerf_qa_torch.data.imaging import resize_image
from nerf_qa_torch.data.video import load_video_frames, write_mjpeg_mp4


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def extract(video_path: str, out_dir: str, sizes=(256,),
            keep_original: bool = True, max_frames: int | None = None):
    frames = load_video_frames(video_path, resize=False, max_frames=max_frames)
    name = os.path.splitext(os.path.basename(video_path))[0]
    base = os.path.join(out_dir, name)
    written = []
    if keep_original:
        orig_dir = os.path.join(base, "original_size")
        os.makedirs(orig_dir, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray((f * 255).astype(np.uint8)).save(
                os.path.join(orig_dir, f"{i:03d}.png")
            )
        written.append(orig_dir)
    for side in sizes:
        sq_dir = os.path.join(base, f"{side}x{side}")
        os.makedirs(sq_dir, exist_ok=True)
        for i, f in enumerate(frames):
            img = resize_image(f, side, side)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(sq_dir, f"{i:03d}.png")
            )
        written.append(sq_dir)
    return written, frames


def main(argv=None):
    p = argparse.ArgumentParser(description="mp4/frame-dir -> frame PNGs")
    p.add_argument("--video", required=True,
                   help="mp4 file or directory of frames")
    p.add_argument("--out-dir", default=None,
                   help="frame-tree output root (required unless --to-mp4)")
    p.add_argument("--sizes", nargs="*", type=int, default=[256])
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--check", action="store_true",
                   help="PSNR round-trip sanity check on frame 0")
    p.add_argument("--to-mp4", metavar="PATH", default=None,
                   help="remux as a Motion-JPEG mp4 (decodes through the "
                        "native demuxer, no ffmpeg needed) instead of "
                        "extracting frame trees")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--quality", type=int, default=90)
    args = p.parse_args(argv)
    if args.to_mp4:
        frames = load_video_frames(args.video, resize=False,
                                   max_frames=args.max_frames)
        os.makedirs(os.path.dirname(os.path.abspath(args.to_mp4)),
                    exist_ok=True)
        write_mjpeg_mp4(args.to_mp4, frames, fps=args.fps,
                        quality=args.quality)
        print(f"wrote: {args.to_mp4} ({len(frames)} frames)")
        return
    if not args.out_dir:
        p.error("--out-dir is required unless --to-mp4 is given")
    written, frames = extract(args.video, args.out_dir, tuple(args.sizes),
                              max_frames=args.max_frames)
    print("wrote:", *written, sep="\n  ")
    if args.check and len(frames):
        f0 = frames[0]
        rt = np.asarray(
            Image.open(os.path.join(written[0], "000.png")), np.float32
        ) / 255.0
        print(f"frame-0 round-trip PSNR: {psnr(f0, rt):.2f} dB")


if __name__ == "__main__":
    main()
