// Native host parser for raytracerfacility_tpu_torch (the part of the
// JAX package's native/src/rtf_native.cpp that the port uses): the
// CompressedBTF text-database number parser. A plain C ABI, bound from
// Python with ctypes (native/__init__.py builds it with g++ at first use).

#include <cstdio>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Whitespace-separated numeric file parser (BTF text databases).
// Replaces ParseFloatData/ParseIntData (ref CompressedBTF.cpp:7-56): the
// UBO databases are tens of MB of ASCII numbers; strtod in a tight loop is
// much faster than Python tokenization.
//
// Returns the number of values parsed into out (the caller allocates
// capacity), or -1 if the file cannot be read. The first 4 values of any
// array file are the "rows cols min max" header; the caller slices.
// ---------------------------------------------------------------------------
long long rtf_parse_doubles(const char* path, double* out, long long capacity) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(fp); return -1; }
    size_t got = fread(buf, 1, size, fp);
    fclose(fp);
    buf[got] = '\0';

    long long count = 0;
    char* p = buf;
    char* endp;
    while (count < capacity) {
        double v = strtod(p, &endp);
        if (endp == p) {
            // skip a non-numeric char (shouldn't happen in valid files)
            if (*p == '\0') break;
            ++p;
            continue;
        }
        out[count++] = v;
        p = endp;
    }
    free(buf);
    return count;
}

// Header-only peek: reads the first two values (rows, cols).
int rtf_parse_header(const char* path, long long* rows, long long* cols) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    char line[256];
    if (!fgets(line, sizeof(line), fp)) { fclose(fp); return -1; }
    fclose(fp);
    double r, c;
    if (sscanf(line, "%lf %lf", &r, &c) != 2) return -1;
    *rows = (long long)r;
    *cols = (long long)c;
    return 0;
}

}  // extern "C"
