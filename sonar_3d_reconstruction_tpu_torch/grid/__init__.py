"""Map state: the brick grid and its bucketed key table."""


def check_state_backend(state, backend: str) -> None:
    """ValueError when a resumed map ``state`` is not of ``backend``'s type
    (the records' key layout follows the backend, so a mismatch would
    write voxels through the wrong key interpretation).  ``state=None``
    and backends with no single-card state type (the sharded engines check
    their own) pass."""
    if state is None:
        return
    # imported here: the grid modules import this package
    from sonar_3d_reconstruction_tpu_torch.grid.brick import BrickGridState
    from sonar_3d_reconstruction_tpu_torch.grid.dense import DenseGridState
    from sonar_3d_reconstruction_tpu_torch.grid.hash import HashGridState

    expected = {"brick": BrickGridState, "hash": HashGridState,
                "dense": DenseGridState}.get(backend)
    if expected is not None and not isinstance(state, expected):
        raise ValueError(
            f"map state {type(state).__name__} does not match "
            f"backend={backend!r} (expected {expected.__name__}); pass the "
            f"matching backend= when resuming a saved map"
        )
