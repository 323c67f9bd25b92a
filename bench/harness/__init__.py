"""The benchmark's general machinery: the manifest and the files it names,
spans, the device trace's reduction and the result line."""
