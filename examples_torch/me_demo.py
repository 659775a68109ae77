"""Pyramidal motion-estimation harness on the PyTorch port
(``examples/me_demo.py``'s twin; me_test.py equivalent, headless).

Runs the coarse-to-fine block-matching flow (``ops.estimate_motion_pyramid``)
on the Middlebury frame10/11 pair on the card, writes layer{0,1,2}.flo like
the reference (me_test.py:83-92) and scores every level against the
flow10.flo ground truth with average endpoint error. The HSV flow images,
the search overlay and the --probe zoom need cv2, as in the JAX script;
without cv2 the script says it left them out.

  python examples_torch/me_demo.py [--seed-mode fixed|shipped] [--method fast]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import _common  # noqa: E402


def main():
    from oclcomputervision_tpu_torch.ops import estimate_motion_pyramid
    from oclcomputervision_tpu_torch.utils import asset_path, epe, load_gray, read_flo, write_flo
    from oclcomputervision_tpu_torch.utils.profiling import timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed-mode", default="fixed", choices=["fixed", "shipped"])
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--method", default="exact", choices=["exact", "fast"])
    ap.add_argument("--smooth", type=int, default=0,
                    help="median-filter kernel between levels (0=off; 9 halves EPE)")
    ap.add_argument("--subpixel", type=int, default=0,
                    help="rounds of (equiangular subpixel refine -> median) per "
                         "level (0=off; 12 cuts EPE a further ~35%% over --smooth 9)")
    ap.add_argument("--outdir", default=_common.OUT_DIR)
    ap.add_argument("--probe", type=int, nargs=2, metavar=("Y", "X"),
                    help="also write the zoomed search view at this pixel (needs cv2)")
    ap.add_argument("--refine", default="auto",
                    choices=["auto", "exact", "none"],
                    help="hybrid refinement schedule for --method fast "
                         "(see estimate_motion_pyramid)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)
    cv2 = _common.optional("cv2")
    os.makedirs(args.outdir, exist_ok=True)

    g0 = load_gray("frame10.png")
    g1 = load_gray("frame11.png")
    gt = read_flo(asset_path("flow10.flo"))

    flows, ms = timed(
        estimate_motion_pyramid, g0, g1, args.levels, 15, 5, args.seed_mode,
        args.method, args.smooth, subpixel=args.subpixel, refine=args.refine, device=dev,
    )
    flows = [f.cpu().numpy() for f in flows]
    print(f"{args.levels}-level pyramid flow on {_common.device_label(dev)}: {ms:.1f} ms "
          f"(first call)")

    print(f"zero-flow EPE baseline: {epe(np.zeros_like(gt), gt):.3f}")
    for lv, mv in enumerate(flows):
        scale = 2 ** (len(flows) - 1 - lv)
        gts = gt[::scale, ::scale] / scale
        gts = gts[: mv.shape[0], : mv.shape[1]]
        path = os.path.join(args.outdir, f"layer{lv}.flo")
        write_flo(mv, path)
        print(f"layer {lv} {mv.shape[1]}x{mv.shape[0]}: EPE {epe(mv, gts):.3f} -> {path}")
        if cv2 is not None:
            from oclcomputervision_tpu_torch.compat import mv2hsv

            cv2.imwrite(os.path.join(args.outdir, f"layer{lv}.png"), mv2hsv(mv, scale))

    if cv2 is None:
        print("cv2 is not installed: no layer PNGs, search overlay"
              + (" or probe view" if args.probe else ""))
        return
    if hasattr(cv2, "optflow"):
        base = cv2.optflow.calcOpticalFlowSparseToDense(g0, g1)
        print(f"cv2 sparse-to-dense baseline EPE: {epe(base, gt):.3f}")

    overlay = write_search_overlay(
        cv2, g0, flows[-1], 15, 5, os.path.join(args.outdir, "search_overlay.png"))
    print(f"search/flow overlay -> {overlay}")
    if args.probe:
        py, px = args.probe
        zoom = write_probe_zoom(
            cv2, g0, g1, flows[-1], py, px, 15, 5,
            os.path.join(args.outdir, f"probe_{py}_{px}.png"),
        )
        print(f"zoomed probe view -> {zoom}")


def write_search_overlay(cv2, g0, mv, search_size, patch_size, path, grid=24):
    """Headless equivalent of the reference's visualizeSearch/visualizeME
    cv2 windows (me_pyramid.py:51-84, 129): draws, on frame 0, the search
    window and patch box at a sparse probe grid and the matched
    displacement as an arrow, then writes ONE annotated image."""
    img = cv2.cvtColor(g0, cv2.COLOR_GRAY2BGR)
    pm, sm = patch_size // 2, search_size // 2
    h, w = g0.shape
    for y in range(grid, h - grid, grid):
        for x in range(grid, w - grid, grid):
            u, v = mv[y, x]
            cv2.rectangle(img, (x - sm, y - sm), (x + sm, y + sm), (80, 80, 80), 1)
            cv2.rectangle(img, (x - pm, y - pm), (x + pm, y + pm), (0, 200, 0), 1)
            cv2.arrowedLine(
                img, (x, y), (int(round(x + u)), int(round(y + v))),
                (0, 0, 255), 1, tipLength=0.35,
            )
    cv2.imwrite(path, img)
    return path


def write_probe_zoom(cv2, g0, g1, mv, y, x, search_size, patch_size, path, scale=12):
    """Headless twin of the reference's per-candidate visualizeSearch loop
    (me_pyramid.py:59-64, 75-84): ONE zoomed image of probe (y, x)'s search
    region in frame 1 with the zero-displacement candidate box (red) and the
    matched box (green), beside the zoomed patch from frame 0."""
    pm, sm = patch_size // 2, search_size // 2
    h, w = g0.shape
    y = int(np.clip(y, sm, h - sm - 1))
    x = int(np.clip(x, sm, w - sm - 1))
    region = g1[y - sm : y + sm + 1, x - sm : x + sm + 1]
    big = cv2.cvtColor(region, cv2.COLOR_GRAY2BGR)
    big = cv2.resize(
        big, (big.shape[1] * scale, big.shape[0] * scale), interpolation=cv2.INTER_NEAREST,
    )

    def box(img, cy, cx, color):
        cv2.rectangle(
            img,
            ((cx - pm) * scale, (cy - pm) * scale),
            ((cx + pm + 1) * scale - 1, (cy + pm + 1) * scale - 1),
            color,
            2,
        )

    u, v = mv[y, x]
    box(big, sm, sm, (0, 0, 255))  # zero-displacement candidate
    box(big, sm + int(round(v)), sm + int(round(u)), (0, 255, 0))  # match
    patch = g0[y - pm : y + pm + 1, x - pm : x + pm + 1]
    pz = cv2.cvtColor(patch, cv2.COLOR_GRAY2BGR)
    pz = cv2.resize(
        pz, (patch_size * scale, patch_size * scale), interpolation=cv2.INTER_NEAREST,
    )
    panel = np.zeros((big.shape[0], big.shape[1] + pz.shape[1] + scale, 3), np.uint8)
    panel[:, : big.shape[1]] = big
    panel[: pz.shape[0], big.shape[1] + scale :] = pz
    cv2.imwrite(path, panel)
    return path


if __name__ == "__main__":
    main()
