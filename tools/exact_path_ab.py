"""Time the exact path of a checkout on one CUDA card, under chosen TF32
flags: the A/B of a change against its parent on the same card.

    python3 tools/exact_path_ab.py <checkout dir> off|default

Builds ``chip_smoke.py``'s exact-path pipeline of that checkout
(full-width PyanNet and a float32 ResNet34 trunk, the accelerator gates
"0", the LSTM at "highest") and prints three file-by-file walls over a
3-minute synthetic file. "off" switches TF32 off for cuDNN and CUDA
matmuls before anything runs (what ``chip_smoke.py`` did before the
port pinned its float32 sites); "default" leaves torch's flags as they
are. Run parent, change, change, parent in one call to compare.
"""

import os
import sys
import tempfile
from pathlib import Path

import torch

tree = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(tree))
os.chdir(tree)
if sys.argv[2] == "off":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

import chip_smoke as cs  # noqa: E402

os.environ["PYANNOTE_TPU_LSTM_PRECISION"] = "highest"
cs.set_gates("0")
segmentation, embedding = cs.make_models(torch.float32)
pipeline = cs.build_pipeline(segmentation, embedding, torch.device("cuda", 0))
files = cs.write_files(Path(tempfile.mkdtemp()), (3.0,))
cs.run_one_by_one(pipeline, files)                              # warm
walls = [cs.wall_seconds(lambda: cs.run_one_by_one(pipeline, files))
         for _ in range(3)]
print(f"RESULT {sys.argv[1]} tf32={sys.argv[2]} exact 3 min file by file: "
      f"{' / '.join('%.3f' % w for w in walls)} s; flags after "
      f"{torch.backends.cudnn.allow_tf32} "
      f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
