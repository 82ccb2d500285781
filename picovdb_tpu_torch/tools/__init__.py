"""Command-line tools that drive picovdb_tpu_torch through its public API.

Each tool is a module, run as `python -m picovdb_tpu_torch.tools.<name>`,
with a `main(argv=None)` that tests can call in process. The tools serve
from the card unless `--device cpu` is given, and raise where there is
no card.
"""

import torch


def tool_device(name: str = "cuda") -> torch.device:
    """The device a tool's store lives on: the host for "cpu", else the
    current card; without a card this raises instead of serving from the
    host."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the "
            "host")
    return torch.device("cuda", torch.cuda.current_device())


def sync(device: torch.device) -> None:
    """Wait for the card's work (nothing on the host): a timed region ends
    here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def add_device_flag(parser) -> None:
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="where the store lives (default: the card)")
