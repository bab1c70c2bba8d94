"""``python -m lightcompress_tpu_torch --config x.yml [--device cpu]``."""

from .pipeline import main

if __name__ == "__main__":
    raise SystemExit(main())
