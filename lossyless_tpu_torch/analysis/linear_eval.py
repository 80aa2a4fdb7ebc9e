"""Z linear evaluation: a LinearSVC probe on compressed features.

Counterpart of `lossyless_tpu/analysis/linear_eval.py`: fit a
scikit-learn LinearSVC with a small randomized search over C and
class_weight (or a fixed C), score it on the test features. Host-only;
sklearn is imported when the function runs, so the package imports
without it.
"""

from __future__ import annotations

import numpy as np


def z_linear_eval(z_train, y_train, z_test, y_test, n_iter: int = 8,
                  seed: int = 0, fixed_C: float | None = None) -> dict:
    from sklearn.model_selection import RandomizedSearchCV
    from sklearn.svm import LinearSVC

    if fixed_C is not None:
        clf = LinearSVC(C=fixed_C)
        clf.fit(z_train, y_train)
        acc = float(clf.score(z_test, y_test))
        return {"acc": acc, "err": 1 - acc, "best_C": fixed_C}

    search = RandomizedSearchCV(
        LinearSVC(),
        dict(C=np.logspace(-4, 1, 30),
             class_weight=[None, "balanced"]),
        n_iter=n_iter, random_state=seed, n_jobs=-1, cv=3)
    search.fit(z_train, y_train)
    acc = float(search.score(z_test, y_test))
    return {"acc": acc, "err": 1 - acc,
            "best_C": float(search.best_params_["C"])}
