"""Fixture: an app's layer span whose name is not declared in
``repro_torch/observability/names.py`` -- a benchmark reader that keys on
the declared name would find nothing and read no number.  Must trip the
span-name-registry pass, which reads ``apps/`` as well as the fabric."""
from repro_torch import observability as obs


def predict(model, feats):
    with obs.layer("mpnn.predcit"):            # typo'd, undeclared
        return model(feats)
