// Parallel gitignore-aware filesystem walker.
//
// Native analog of the reference's `ignore` crate parallel walk
// (crates/perceive-core/sources/fs.rs:42-45): N threads pull
// directories from a shared queue, stat entries, prune hidden and
// .gitignore'd subtrees during the walk (so node_modules/.git are never
// descended into), and append file records to a shared buffer.
//
// C ABI for ctypes (perceive_tpu_torch/native/__init__.py):
//   char* fw_walk(const char* root, int nthreads, int respect_gitignore,
//                 long long* out_len);
//     -> malloc'd buffer of "mtime\tatime\tpath\0" records (path last and
//        NUL-terminated: filenames may contain \t or \n but never \0;
//        caller frees via fw_free); NULL on error.
//   void fw_free(char* buf);
//
// Gitignore subset (mirrors the Python fallback in sources/fs.py): blank and
// '#' lines skipped, '!' negation, trailing '/' dir-only, patterns with '/'
// are anchored to their .gitignore's directory, bare patterns match the
// basename at any depth; fnmatch(3) provides * ? [..] semantics.  Last
// matching rule wins, inner files override outer ones.
//
// File sources, in ascending precedence (the reference `ignore` crate's
// WalkBuilder defaults): the user's global gitignore and `.git/info/exclude`
// (both loaded where a `.git` marker makes a directory a repo root), then
// per-directory `.gitignore`, then `.ignore`.  When the walk root sits
// inside a repository, the repo root's files and every `.gitignore`/`.ignore`
// on the path down to the root are inherited ("parents" behavior).

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <fnmatch.h>
#include <sys/stat.h>

namespace {

struct Pattern {
  std::string glob;
  bool negate = false;
  bool dir_only = false;
  bool anchored = false;  // contains '/', match against the relative path
};

struct Rules {
  std::string base;  // directory holding the .gitignore
  std::vector<Pattern> pats;
  std::shared_ptr<Rules> parent;
};

std::shared_ptr<Rules> load_one(const std::string& file, const std::string& base,
                                std::shared_ptr<Rules> parent) {
  std::ifstream f(file);
  if (!f.good()) return parent;
  auto rules = std::make_shared<Rules>();
  rules->base = base;
  rules->parent = std::move(parent);
  std::string line;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line.empty() || line[0] == '#') continue;
    Pattern p;
    if (line[0] == '!') {
      p.negate = true;
      line.erase(0, 1);
    }
    if (!line.empty() && line.back() == '/') {
      p.dir_only = true;
      line.pop_back();
    }
    // anchoring is decided BEFORE stripping the leading '/': "/build"
    // anchors to this .gitignore's directory, it is not a basename pattern
    p.anchored = line.find('/') != std::string::npos;
    if (!line.empty() && line[0] == '/') line.erase(0, 1);
    if (line.empty()) continue;
    p.glob = line;
    rules->pats.push_back(std::move(p));
  }
  if (rules->pats.empty()) return rules->parent;
  return rules;
}

bool path_exists(const std::string& p) {
  struct stat st;
  return lstat(p.c_str(), &st) == 0;
}

// resolution mirrors sources/fs.py global_ignore_path(): env override,
// core.excludesfile from ~/.gitconfig (best effort), XDG, ~/.config
std::string global_ignore_file() {
  const char* env = getenv("PERCEIVE_TPU_GLOBAL_GITIGNORE");
  if (env) return path_exists(env) ? std::string(env) : std::string();
  const char* home = getenv("HOME");
  std::string h = home ? home : "";
  if (!h.empty()) {
    std::ifstream f(h + "/.gitconfig");
    std::string line;
    while (f.good() && std::getline(f, line)) {
      size_t i = line.find_first_not_of(" \t");
      if (i == std::string::npos) continue;
      std::string l = line.substr(i);
      if (l.rfind("excludesfile", 0) == 0 || l.rfind("excludesFile", 0) == 0) {
        size_t eq = l.find('=');
        if (eq == std::string::npos) continue;
        std::string v = l.substr(eq + 1);
        v.erase(0, v.find_first_not_of(" \t"));
        while (!v.empty() && (v.back() == ' ' || v.back() == '\t')) v.pop_back();
        if (!v.empty() && v[0] == '~') v = h + v.substr(1);
        if (path_exists(v)) return v;
      }
    }
  }
  const char* xdg = getenv("XDG_CONFIG_HOME");
  std::string p = (xdg ? std::string(xdg) : h + "/.config") + "/git/ignore";
  return path_exists(p) ? p : std::string();
}

// this directory's ignore files appended to the chain, weakest first
std::shared_ptr<Rules> load_rules(const std::string& dir,
                                  std::shared_ptr<Rules> parent) {
  auto rules = std::move(parent);
  if (path_exists(dir + "/.git")) {  // repo root: global + info/exclude
    std::string g = global_ignore_file();
    if (!g.empty()) rules = load_one(g, dir, std::move(rules));
    rules = load_one(dir + "/.git/info/exclude", dir, std::move(rules));
  }
  rules = load_one(dir + "/.gitignore", dir, std::move(rules));
  rules = load_one(dir + "/.ignore", dir, std::move(rules));
  return rules;
}

// rules inherited from ABOVE the walk root (enclosing repository)
std::shared_ptr<Rules> root_parent_rules(const std::string& root) {
  std::vector<std::string> ancestors;
  std::string cur = root;
  size_t slash;
  bool found = false;
  while ((slash = cur.rfind('/')) != std::string::npos && slash > 0) {
    cur = cur.substr(0, slash);
    ancestors.push_back(cur);
    if (path_exists(cur + "/.git")) {
      found = true;
      break;
    }
  }
  if (!found) return nullptr;
  std::shared_ptr<Rules> rules;
  for (auto it = ancestors.rbegin(); it != ancestors.rend(); ++it)
    rules = load_rules(*it, std::move(rules));
  return rules;
}

// -1 no opinion, 0 keep, 1 ignore — from ONE rules file (last match wins)
int verdict_one(const Rules& r, const std::string& path, bool is_dir,
                const std::string& name) {
  std::string rel =
      path.size() > r.base.size() && path.compare(0, r.base.size(), r.base) == 0
          ? path.substr(r.base.size() + 1)
          : path;
  int v = -1;
  for (const auto& p : r.pats) {
    if (p.dir_only && !is_dir) continue;
    const std::string& subject = p.anchored ? rel : name;
    // anchored patterns must not let '*'/'?' cross '/' (mirrors the Python
    // fallback's [^/]* translation); '**' patterns need cross-segment
    // matching, so they keep the permissive mode
    int flags = (p.anchored && p.glob.find("**") == std::string::npos)
                    ? FNM_PATHNAME
                    : 0;
    if (fnmatch(p.glob.c_str(), subject.c_str(), flags) == 0)
      v = p.negate ? 0 : 1;
  }
  return v;
}

bool ignored(const std::shared_ptr<Rules>& rules, const std::string& path,
             bool is_dir, const std::string& name) {
  // outer rules first so inner files override
  std::vector<const Rules*> chain;
  for (const Rules* r = rules.get(); r; r = r->parent.get())
    chain.push_back(r);
  int v = 0;
  for (auto it = chain.rbegin(); it != chain.rend(); ++it) {
    int one = verdict_one(**it, path, is_dir, name);
    if (one != -1) v = one;
  }
  return v == 1;
}

struct Task {
  std::string dir;
  std::shared_ptr<Rules> rules;
};

struct Walker {
  std::deque<Task> queue;
  std::mutex mu;
  std::condition_variable cv;
  int active = 0;
  bool done = false;
  bool use_gitignore;
  std::string out;
  std::mutex out_mu;

  void push(Task t) {
    {
      std::lock_guard<std::mutex> l(mu);
      queue.push_back(std::move(t));
    }
    cv.notify_one();
  }

  void worker() {
    std::string local;
    local.reserve(1 << 16);
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> l(mu);
        cv.wait(l, [&] { return !queue.empty() || (active == 0 && queue.empty()); });
        if (queue.empty()) break;  // active==0 and empty -> finished
        t = std::move(queue.front());
        queue.pop_front();
        ++active;
      }
      process(t, local);
      {
        std::lock_guard<std::mutex> l(mu);
        --active;
        if (active == 0 && queue.empty()) cv.notify_all();
      }
    }
    if (!local.empty()) {
      std::lock_guard<std::mutex> l(out_mu);
      out += local;
    }
  }

  void process(const Task& t, std::string& local) {
    auto rules = t.rules;
    if (use_gitignore) rules = load_rules(t.dir, rules);
    DIR* d = opendir(t.dir.c_str());
    if (!d) return;
    struct dirent* e;
    while ((e = readdir(d)) != nullptr) {
      const char* name = e->d_name;
      if (name[0] == '.') continue;  // hidden (and . / ..)
      std::string path = t.dir + "/" + name;
      struct stat st;
      if (lstat(path.c_str(), &st) != 0) continue;
      bool is_dir = S_ISDIR(st.st_mode);
      bool is_file = S_ISREG(st.st_mode);
      if (!is_dir && !is_file) continue;  // symlinks etc. skipped
      if (use_gitignore && rules && ignored(rules, path, is_dir, name))
        continue;
      if (is_dir) {
        push(Task{path, rules});
      } else {
        // record: mtime \t atime \t path \0 — the path goes LAST and is
        // NUL-terminated so names containing tabs/newlines parse fine
        local += std::to_string((long long)st.st_mtime);
        local += '\t';
        local += std::to_string((long long)st.st_atime);
        local += '\t';
        local += path;
        local += '\0';
        if (local.size() > (1 << 20)) {
          std::lock_guard<std::mutex> l(out_mu);
          out += local;
          local.clear();
        }
      }
    }
    closedir(d);
  }
};

}  // namespace

extern "C" {

char* fw_walk(const char* root, int nthreads, int respect_gitignore,
              long long* out_len) {
  if (!root || !out_len) return nullptr;
  Walker w;
  w.use_gitignore = respect_gitignore != 0;
  std::string r(root);
  while (r.size() > 1 && r.back() == '/') r.pop_back();
  w.push(Task{r, w.use_gitignore ? root_parent_rules(r) : nullptr});
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int i = 0; i < nthreads; ++i)
    threads.emplace_back([&w] { w.worker(); });
  for (auto& th : threads) th.join();
  char* buf = (char*)malloc(w.out.size() + 1);
  if (!buf) return nullptr;
  memcpy(buf, w.out.data(), w.out.size());
  buf[w.out.size()] = '\0';
  *out_len = (long long)w.out.size();
  return buf;
}

void fw_free(char* buf) { free(buf); }

}  // extern "C"
