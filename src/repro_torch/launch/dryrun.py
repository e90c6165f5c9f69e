"""``python -m repro_torch.launch.dryrun``: refused, naming its queue item.

The reference's ``launch/dryrun.py`` lowers every benchmark cell on
placeholder devices and reads the compiled XLA HLO for its memory and
collective terms.  This package compiles nothing ahead of time and has
no HLO to read, so its counterpart is a redesign, not a translation; it
waits for ROADMAP.md queue 1, item 2e (with item 5, the HLO half of the
cost model).
"""

from __future__ import annotations

DRYRUN = ("the dry run over placeholder devices (the reference's "
          "launch/dryrun.py, which reads XLA HLO) waits for ROADMAP.md "
          "queue 1, item 2e")


def main(argv=None):
    raise NotImplementedError(DRYRUN)


if __name__ == "__main__":
    main()
