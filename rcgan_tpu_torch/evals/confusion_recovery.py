"""Learned-confusion recovery metric for rcgan-u, copied from
``rcgan_tpu/evals/confusion_recovery.py`` (numpy and scipy).

The reference logs ``max|C - C*|`` drift every 100 iterations
(``cifar10/gan_resnet.py:922-926``) and inverts the learned label
permutation by argmax-binarizing C (``cifar10/gan_resnet.py:429-439``).
This module measures the row-wise total variation distance between
``softmax(confusion_logits)`` and the true C, raw and corrected for the
label permutation that rcgan-u's identifiability argument allows (a
generator that swaps classes is indistinguishable if the learned C
compensates with permuted rows).  The correcting permutation is the
assignment minimizing total row-wise TV (``scipy.optimize
.linear_sum_assignment``, exact).
"""

from __future__ import annotations

import numpy as np


def recovery_report(learned_c: np.ndarray, true_c: np.ndarray) -> dict:
    """Compare a learned confusion matrix with the true one:

    * ``raw_tv``: mean over y of TV(learned_C[y], true_C[y]), TV(p, q) =
      0.5 ||p - q||_1 in [0, 1];
    * ``perm_tv``: the same after the best row assignment pi:
      mean over y of TV(learned_C[y], true_C[pi(y)]);
    * ``perm``: pi as an int array [K] (perm[y] = matched true row);
    * ``perm_is_identity``: False means the generator likely settled on a
      permuted labeling;
    * ``mean_diag``: the mean of the learned diagonal;
    * ``max_drift``: max |C - C*|, the reference's drift log.
    """
    from scipy.optimize import linear_sum_assignment

    lc = np.asarray(learned_c, np.float64)
    tc = np.asarray(true_c, np.float64)
    k = lc.shape[0]
    # cost[y, j] = TV(learned row y, true row j)
    cost = 0.5 * np.abs(lc[:, None, :] - tc[None, :, :]).sum(axis=-1)
    rows, cols = linear_sum_assignment(cost)
    perm = np.empty(k, np.int64)
    perm[rows] = cols
    raw_tv = float(np.mean(np.diag(cost)))
    perm_tv = float(cost[rows, cols].mean())
    return {
        "raw_tv": raw_tv,
        "perm_tv": perm_tv,
        "perm": perm,
        "perm_is_identity": bool((perm == np.arange(k)).all()),
        "mean_diag": float(np.mean(np.diag(lc))),
        "max_drift": float(np.abs(lc - tc).max()),
    }
