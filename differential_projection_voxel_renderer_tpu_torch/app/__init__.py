"""The frame loop: QuadPool, Engine, FrameResult."""
