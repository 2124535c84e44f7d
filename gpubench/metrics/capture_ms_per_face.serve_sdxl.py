"""Device ms a face of the program's ``capture`` stage (each face's
references through the frozen VAE encoder and SDXL UNet) over the profiled
batches: ``capture_ms_per_face.serve``'s definition, read by that file's
reader, loaded here."""

import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("capture_ms_per_face.serve.py")
_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{_path.stem}", _path)
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
read = _reader.read
