"""Share of the profiled restore calls that replayed a captured CUDA graph
(the SDXL cell), in %: ``graph_replay_share.serve``'s definition, read by
that file's reader, loaded here."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("graph_replay_share.serve.py")
_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{_path.stem}", _path)
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
read = _reader.read
