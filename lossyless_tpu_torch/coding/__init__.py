"""Host coding layer: entropy bottleneck, rANS codec, dataset framing."""
