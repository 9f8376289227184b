"""Small copies of the committed configurations, for runs on the CPU."""

import copy

import torch

from benchmark.harness import manifest as mf

CELLS = tuple(w["name"] for w in mf.load_manifest()["workloads"])


# one image of every generator at a small size, each with its arguments as
# the port's make_corpus gives them: the reference codec's tests cover every
# content class, alpha and gray, whatever the committed cells draw
EVERY_GENERATOR = [
    {"category": "icon", "generator": "icon", "count": 2, "width": 32,
     "height": 32, "args": {"n_shapes": 5, "glow_w": 0.6, "glow_peak": 0.5}},
    {"category": "pngimg", "generator": "pngimg", "count": 1, "width": 32,
     "height": 32, "args": {"n_shapes": 6}},
    {"category": "screenshot", "generator": "screenshot", "count": 1,
     "width": 40, "height": 24},
    {"category": "photo", "generator": "photo", "count": 2, "width": 160,
     "height": 120},
    {"category": "texture", "generator": "texture", "count": 1, "width": 40,
     "height": 24},
    {"category": "photo_rgba", "generator": "photo_rgba", "count": 1,
     "width": 40, "height": 24},
    {"category": "mono_doc", "generator": "mono_doc", "count": 1, "width": 40,
     "height": 24},
]


def small_config(cell_name):
    """The cell's configuration with at most two images a category, icons
    32x32, photos 160x120 (smaller ones lie wholly in the generator's
    posterized plateau, every sample even) and other images 40x24; the
    rest as committed."""
    man = mf.load_manifest()
    _, cfg, _ = mf.load_cell(man, cell_name)
    cfg = copy.deepcopy(cfg)
    for im in cfg["images"]:
        im["count"] = min(im["count"], 2)
        if im["generator"] in ("icon", "pngimg"):
            im["width"] = im["height"] = 32
        elif im["generator"] == "photo":
            im["width"], im["height"] = 160, 120
        else:
            im["width"], im["height"] = 40, 24
    return cfg


def run_small(cell_name, seed=2**31 + 77, trace=False, control=False):
    """One run of the cell on the CPU at the small size, one CPU entry a
    card of the cell."""
    from benchmark.harness import runner

    cfg = small_config(cell_name)
    return runner.run(cell_name, seed, 0.2, trace,
                      devices=[torch.device("cpu")] * cfg["chips"],
                      config=cfg, control=control)
