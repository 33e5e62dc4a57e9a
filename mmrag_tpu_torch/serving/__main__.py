"""CLI entrypoint: ``python -m mmrag_tpu_torch.serving --host 0.0.0.0 --port 8000``.

Role of the reference's uvicorn launcher (``main.py:14-21``); HOST/PORT env
vars honored the same way. ``--platform`` (or ``MMRAG_PLATFORM``) picks the
torch device: the card by default, ``cpu`` only when asked; without CUDA and
without ``cpu`` the engine raises rather than fall back.
"""

import argparse
import logging
import os


def main() -> None:
    parser = argparse.ArgumentParser(description="mmrag-tpu API server (PyTorch port)")
    parser.add_argument("--host", default=os.environ.get("HOST", "0.0.0.0"))
    parser.add_argument("--port", type=int, default=int(os.environ.get("PORT", "8000")))
    parser.add_argument("--log-level", default=os.environ.get("LOG_LEVEL", "INFO"))
    parser.add_argument(
        "--platform", default=os.environ.get("MMRAG_PLATFORM", ""),
        help="torch device to serve on: cuda (the default) or cpu",
    )
    args = parser.parse_args()
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from .http import serve_forever

    serve_forever(args.host, args.port, device=args.platform or None)


if __name__ == "__main__":
    main()
