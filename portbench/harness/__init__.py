"""The benchmark's harness: discovery by name (``bench``), the inputs made
from the seed (``inputs``), the program's round (``program``, the only
module that imports the port), the device trace (``trace``), the work a
round needs (``yardstick``), the comparison that decides ``correct``
(``check``) and a run from set-up to its result line (``cell``)."""
